"""PyTorch + CUDA port of the region-QA serving path for NVIDIA Hopper.

Beside the JAX reference package ``spatialrgpt_tpu``: same module names
(``ops/``, ``models/``, ``serving/``, ``utils/``), same public layouts
((B, S, H, D) attention tensors, NHWC images, (N, R, H, W) masks), and
parameters under the HF tensor names that ``spatialrgpt_tpu/utils/export.py``
writes.  The attention kernels are CUDA C++ for ``sm_90a`` under ``csrc/``,
built at first use by ``ops/_build.py``.  This package imports ``torch``
and never ``jax``; the framework-free modules of the JAX package (config,
constants, data/splice, utils/export) are imported from there.  The names
a caller of the port needs from them are re-exported here, so a user of
the port imports nothing from the JAX package.
"""

from spatialrgpt_tpu.config import SpatialRGPTConfig, preset
from spatialrgpt_tpu.constants import IMAGE_TOKEN_INDEX, NUM_TOKENS_PER_IMAGE
from spatialrgpt_tpu.data.splice import expand_rows

__all__ = ["IMAGE_TOKEN_INDEX", "NUM_TOKENS_PER_IMAGE", "SpatialRGPTConfig", "expand_rows", "preset"]
