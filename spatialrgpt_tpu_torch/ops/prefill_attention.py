"""K2: causal x packed-segment (x sliding-window) prefill attention, GQA.

Port of the Pallas kernel
``spatialrgpt_tpu/ops/prefill_attention.py::onepass_attention``; the CUDA
kernel is ``csrc/prefill_attention.cu`` on the Hopper main loop of
``csrc/attention_sm90.cuh`` (TMA + wgmma).  ``onepass_attention`` launches it
for CUDA tensors and takes the plain version ``onepass_attention_plain``
(the twin of the reference's ``_xla_reference``) only for CPU tensors.
``launches`` counts kernel launches.  The kernel route is differentiable:
its backward recomputes the plain version and differentiates it
(``ops/_autograd.py``), as the reference's ``custom_vjp`` recomputes in XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from spatialrgpt_tpu_torch.ops import _build
from spatialrgpt_tpu_torch.ops._autograd import KernelForwardPlainGrad
from spatialrgpt_tpu_torch.ops._checks import FOLD_ROWS, check_bshd

NEG_INF = -1e30

launches = 0  # kernel launches since the last reset (plain-path calls do not count)


def onepass_attention_plain(
    q: torch.Tensor,  # (B, S, Hq, D)
    k: torch.Tensor,  # (B, S, Hk, D)
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S); 0 = padding
    window: Optional[int] = None,
) -> torch.Tensor:
    """Masked-softmax attention in plain PyTorch (twin of
    prefill_attention.py::_xla_reference): f32 scores, softmax, P cast to
    the value dtype, rows of segment 0 zeroed."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    if segment_ids is None:
        segment_ids = torch.ones((b, s), dtype=torch.int32, device=q.device)
    same = (segment_ids[:, :, None] == segment_ids[:, None, :]) & (segment_ids[:, :, None] != 0)
    qi = torch.arange(s, device=q.device)[:, None]
    ki = torch.arange(s, device=q.device)[None, :]
    ok = same & (qi >= ki)[None]
    if window is not None:
        ok &= ((qi - ki) < window)[None]
    qg = q.reshape(b, s, hk, g, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * d**-0.5
    scores = torch.where(ok[:, None, None], scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    probs = probs * (segment_ids != 0)[:, None, None, :, None].to(probs.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def onepass_attention(
    q: torch.Tensor,  # (B, S, Hq, D) bf16 on the card
    k: torch.Tensor,  # (B, S, Hk, D)
    v: torch.Tensor,
    segment_ids: Optional[torch.Tensor] = None,  # (B, S) int32; 0 = padding
    window: Optional[int] = None,
) -> torch.Tensor:
    """Causal attention within packed segments (optionally windowed);
    (B, S, Hq, D).  A row with no live key (segment 0) is zeros."""
    if q.device.type == "cpu":
        return onepass_attention_plain(q, k, v, segment_ids, window)
    if q.dim() != 4 or k.dim() != 4 or q.shape[2] % k.shape[2] or FOLD_ROWS % (q.shape[2] // k.shape[2]):
        raise ValueError(f"onepass_attention: q {tuple(q.shape)} / k {tuple(k.shape)}: "
                         f"Hq/Hk must be an integer dividing {FOLD_ROWS}")
    B, S, Hq, D = q.shape
    if segment_ids is None:
        segment_ids = torch.ones((B, S), dtype=torch.int32, device=q.device)
    if segment_ids.shape != (B, S) or segment_ids.device != q.device:
        raise ValueError(f"onepass_attention: segment_ids {tuple(segment_ids.shape)} on {segment_ids.device}")
    if window is not None and window < 1:
        raise ValueError(f"onepass_attention: window {window} < 1")
    check_bshd("onepass_attention", q, k, v)
    seg = segment_ids.to(torch.int32).contiguous()
    return KernelForwardPlainGrad.apply(
        lambda q, k, v: _launch(q, k, v, seg, window), lambda q, k, v: onepass_attention_plain(q, k, v, seg, window),
        q, k, v,
    )


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor, window: Optional[int]) -> torch.Tensor:
    B, S, Hq, D = q.shape
    out = torch.empty((B, S, Hq, D), dtype=q.dtype, device=q.device)
    err = _build.lib().srgpt_prefill_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(), out.data_ptr(),
        B, S, Hq, k.shape[2], D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        0 if window is None else int(window), D**-0.5, _build.stream_ptr(q),
    )
    _build.check(err, "onepass_attention")
    global launches
    launches += 1
    return out
