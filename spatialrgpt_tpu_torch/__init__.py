"""PyTorch + CUDA port of the region-QA serving path and the stage-1 align
training step for NVIDIA Hopper.

Beside the JAX reference package ``spatialrgpt_tpu``: same module names
(``ops/``, ``models/``, ``serving/``, ``train/``, ``utils/``), same public layouts
((B, S, H, D) attention tensors, NHWC images, (N, R, H, W) masks), and
parameters under the HF tensor names that ``spatialrgpt_tpu/utils/export.py``
writes.  The attention kernels are CUDA C++ for ``sm_90a`` under ``csrc/``,
built at first use by ``ops/_build.py``.  This package imports ``torch``
and never ``jax``, and nothing of the JAX package: it keeps its own copies
of the framework-free modules it needs (``config``, ``constants``,
``conversation``, ``data/splice``, ``demo/engine``, ``utils/export``).  The
names a caller needs most are re-exported here.
"""

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig, preset
from spatialrgpt_tpu_torch.constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX, NUM_TOKENS_PER_IMAGE
from spatialrgpt_tpu_torch.data.splice import expand_rows, pack_rows

__all__ = [
    "IGNORE_INDEX", "IMAGE_TOKEN_INDEX", "NUM_TOKENS_PER_IMAGE", "SpatialRGPTConfig", "expand_rows", "pack_rows",
    "preset",
]
