"""Model loading (port of ``spatialrgpt_tpu/models/builder.py``): a
composite checkpoint directory -> (tokenizer, model, config, processor).

The ``<mask>`` and ``<depth>`` tokens are added to the tokenizer and their
ids recorded in the config; when the tokenizer then counts more entries
than the stored vocabulary, the embedding table and the LM head grow to it
(``utils/checkpoint.py::load_reference_checkpoint``).  ``transformers`` is
imported inside ``load_tokenizer`` only, and only when the caller brings
no tokenizer of its own.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from spatialrgpt_tpu_torch.config import SpatialRGPTConfig
from spatialrgpt_tpu_torch.constants import DEFAULT_DEPTH_TOKEN, DEFAULT_MASK_TOKEN
from spatialrgpt_tpu_torch.data.preprocess import SiglipProcessor
from spatialrgpt_tpu_torch.models.vlm import SpatialRGPT
from spatialrgpt_tpu_torch.utils.checkpoint import load_reference_checkpoint


def get_model_name_from_path(model_path: str) -> str:
    model_path = model_path.strip("/")
    parts = model_path.split("/")
    if parts[-1].startswith("checkpoint-"):
        return parts[-2] + "_" + parts[-1]
    return parts[-1]


def load_tokenizer(model_path: str, model_max_length: Optional[int] = None, tokenizer=None):
    """(tokenizer, mask id, depth id, tokens added): the tokenizer of
    ``{root}/llm`` (HF layout), or ``tokenizer`` when given, with the region
    tokens added at the end of its vocabulary."""
    if tokenizer is None:
        from transformers import AutoTokenizer

        llm_dir = os.path.join(model_path, "llm")
        tokenizer = AutoTokenizer.from_pretrained(llm_dir if os.path.isdir(llm_dir) else model_path, use_fast=True)
    if model_max_length:
        tokenizer.model_max_length = model_max_length
    added = tokenizer.add_tokens([DEFAULT_MASK_TOKEN, DEFAULT_DEPTH_TOKEN], special_tokens=True)
    mask_id = tokenizer.convert_tokens_to_ids(DEFAULT_MASK_TOKEN)
    depth_id = tokenizer.convert_tokens_to_ids(DEFAULT_DEPTH_TOKEN)
    return tokenizer, mask_id, depth_id, added


def load_pretrained_model(
    model_path: str, device, dtype=torch.bfloat16, tokenizer=None,
) -> Tuple[object, SpatialRGPT, SpatialRGPTConfig, SiglipProcessor]:
    """Composite checkpoint -> (tokenizer, model on ``device``, cfg, image
    processor)."""
    cfg = SpatialRGPTConfig.load(model_path)
    tokenizer, mask_id, depth_id, _ = load_tokenizer(model_path, cfg.model_max_length, tokenizer)
    cfg = cfg.replace(
        mask_token_id=mask_id,
        depth_token_id=depth_id,
        num_extra_tokens=max(cfg.num_extra_tokens, len(tokenizer) - cfg.llm.vocab_size),
    )
    model = load_reference_checkpoint(model_path, cfg, device, dtype, vocab_rows=len(tokenizer))
    return tokenizer, model, cfg, SiglipProcessor(size=cfg.vision.image_size)
