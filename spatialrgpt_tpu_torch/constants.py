"""Model-level constants shared across the framework.

Contract surface mirrors the reference (llava/constants.py:25-33) so that
checkpoints, datasets and prompts interoperate bit-for-bit.

The port's own copy of ``spatialrgpt_tpu/constants.py``.
"""

IGNORE_INDEX = -100
IMAGE_TOKEN_INDEX = -200

DEFAULT_IMAGE_TOKEN = "<image>"
DEFAULT_IMAGE_PATCH_TOKEN = "<im_patch>"
DEFAULT_IM_START_TOKEN = "<im_start>"
DEFAULT_IM_END_TOKEN = "<im_end>"
IMAGE_PLACEHOLDER = "<image-placeholder>"
DEFAULT_MASK_TOKEN = "<mask>"
DEFAULT_DEPTH_TOKEN = "<depth>"

# SigLIP-so400m-p14@384 -> 27x27 = 729 tower tokens; mlp_downsample packs
# 2x2 patches into channels -> 14x14 = 196 LLM tokens per image
# (reference: llava/data/dataset.py:1976, base_projector.py:32-52).
NUM_TOKENS_PER_IMAGE = 196
