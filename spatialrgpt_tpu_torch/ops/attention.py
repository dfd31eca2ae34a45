"""Prefill attention with interchangeable implementations (port of
``spatialrgpt_tpu/ops/attention.py::causal_attention``).

``impl="xla"`` is the plain path: masked softmax in plain PyTorch, the
twin of the reference's XLA path (its function is exactly the plain
version of kernel K2).  ``impl="onepass"`` runs kernel K2
(``ops/prefill_attention.py``) on CUDA tensors and the plain path on CPU
tensors, as the reference runs its Pallas kernel on a TPU and XLA
elsewhere.  ``impl="pallas"`` (the training path, the name
``train/args.py`` uses) runs kernel K4 (``ops/flash_attention.py``,
differentiable) on CUDA tensors and K4's plain versions on CPU tensors.
Any other ``impl`` raises.  ``window`` (key j is live for query i only if
i - j < window) goes to every route, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch

from spatialrgpt_tpu_torch.ops.flash_attention import flash_attention
from spatialrgpt_tpu_torch.ops.prefill_attention import onepass_attention, onepass_attention_plain


def causal_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, S, Hk, D)
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S), 0 = padding
    impl: str = "xla",
    window: Optional[int] = None,  # sliding-window attention (mistral)
) -> torch.Tensor:
    if impl == "pallas":
        return flash_attention(q, k, v, segment_ids=segment_ids, window=window)
    if impl == "onepass":
        return onepass_attention(q, k, v, segment_ids=segment_ids, window=window)
    if impl == "xla":
        return onepass_attention_plain(q, k, v, segment_ids=segment_ids, window=window)
    raise ValueError(f"unknown attention impl: {impl}")
