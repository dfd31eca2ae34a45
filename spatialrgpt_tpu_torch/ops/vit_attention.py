"""K1: bidirectional whole-sequence attention for ViT towers.

Port of the Pallas kernel ``spatialrgpt_tpu/ops/vit_attention.py::vit_attention``;
the CUDA kernel is ``csrc/vit_attention.cu`` on the Hopper main loop of
``csrc/attention_sm90.cuh`` (TMA + wgmma; head dims up to 80 on its narrow
form, 80 < D <= 128 on its wide one).  ``vit_attention`` launches it
for CUDA tensors and takes the plain version ``vit_attention_plain`` only
for tensors on the CPU.  ``launches`` counts kernel launches.  The kernel
route is differentiable: its backward recomputes the plain version and
differentiates it (``ops/_autograd.py``), as the reference's ``custom_vjp``
recomputes in XLA.
"""

from __future__ import annotations

from typing import Optional

import torch

from spatialrgpt_tpu_torch.ops import _build
from spatialrgpt_tpu_torch.ops._autograd import KernelForwardPlainGrad
from spatialrgpt_tpu_torch.ops._checks import K1_MAX_HEAD_DIM, check_bshd

NEG_INF = -1e30

launches = 0  # kernel launches since the last reset (plain-path calls do not count)


def vit_attention_plain(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """The Pallas kernel's function in plain PyTorch: f32 scores from the
    input dtype, keys >= valid_len masked, one softmax pass, P cast to the
    value dtype before PV with f32 accumulation, then divided by the row sum."""
    S, D = q.shape[1], q.shape[3]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D**-0.5
    if valid_len is not None and valid_len < S:
        cols = torch.arange(S, device=q.device)
        s = torch.where(cols < valid_len, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float()) / l
    return o.transpose(1, 2).to(q.dtype)


def vit_attention(
    q: torch.Tensor,  # (B, S, H, D) bf16 on the card
    k: torch.Tensor,
    v: torch.Tensor,
    valid_len: Optional[int] = None,
) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H, D).  Keys at positions >= ``valid_len``
    (default S) are masked."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v, valid_len)
    if k.shape != q.shape:
        raise ValueError(f"vit_attention: k/v shape {tuple(k.shape)} != q shape {tuple(q.shape)}")
    if q.dim() == 4 and q.shape[3] > K1_MAX_HEAD_DIM:
        raise ValueError(f"vit_attention: head dim {q.shape[3]} > {K1_MAX_HEAD_DIM}, the kernel's widest")
    check_bshd("vit_attention", q, k, v, K1_MAX_HEAD_DIM)
    S = q.shape[1]
    vl = S if valid_len is None else int(valid_len)
    if not 1 <= vl <= S:
        raise ValueError(f"vit_attention: valid_len {vl} outside [1, {S}]")
    return KernelForwardPlainGrad.apply(
        lambda q, k, v: _launch(q, k, v, vl), lambda q, k, v: vit_attention_plain(q, k, v, vl), q, k, v
    )


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, valid_len: int) -> torch.Tensor:
    B, S, H, D = q.shape
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = _build.lib().srgpt_vit_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, S, H, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
        valid_len, D**-0.5, _build.stream_ptr(q),
    )
    _build.check(err, "vit_attention")
    global launches
    launches += 1
    return out
