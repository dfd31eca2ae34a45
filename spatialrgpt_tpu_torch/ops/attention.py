"""Prefill attention with interchangeable implementations (port of
``spatialrgpt_tpu/ops/attention.py::causal_attention``).

``impl="xla"`` is the plain path: masked softmax in plain PyTorch, the
twin of the reference's XLA path (its function is exactly the plain
version of kernel K2).  ``impl="onepass"`` runs kernel K2
(``ops/prefill_attention.py``) on CUDA tensors and the plain path on CPU
tensors, as the reference runs its Pallas kernel on a TPU and XLA
elsewhere.  Any other ``impl`` raises.  The sliding window waits with
the decoders that use it (K2 already takes one).
"""

from __future__ import annotations

from typing import Optional

import torch

from spatialrgpt_tpu_torch.ops.prefill_attention import onepass_attention, onepass_attention_plain


def causal_attention(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, S, Hk, D)
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S), 0 = padding
    impl: str = "xla",
) -> torch.Tensor:
    if impl == "onepass":
        return onepass_attention(q, k, v, segment_ids=segment_ids)
    if impl == "xla":
        return onepass_attention_plain(q, k, v, segment_ids=segment_ids)
    raise ValueError(f"unknown attention impl: {impl}")
