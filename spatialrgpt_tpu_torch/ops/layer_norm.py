"""K6: fused one-pass row LayerNorm.

Port of the Pallas kernel ``spatialrgpt_tpu/ops/layer_norm.py::fused_layer_norm``;
the CUDA kernel is ``csrc/layer_norm.cu``.  ``fused_layer_norm`` launches it
for CUDA tensors and takes the plain version ``fused_layer_norm_plain``
only for tensors on the CPU.  ``launches`` counts kernel launches.  The
kernel route is differentiable: its backward differentiates the recomputed
plain version (``ops/_autograd.py``), so a trained LayerNorm loses no
gradient.  The kernel takes ``weight`` and ``bias`` in the dtype the model
holds them in (bf16, or float32) and widens them in registers: one
LayerNorm is one launch, with no cast kernels.  ``ops/layers.py::layer_norm``
routes here under ``SRGPT_FUSED_LN=1``, with the reference's gate.
"""

from __future__ import annotations

import torch

from spatialrgpt_tpu_torch.ops import _build
from spatialrgpt_tpu_torch.ops._autograd import KernelForwardPlainGrad
from spatialrgpt_tpu_torch.ops._checks import check_dtype, check_on_cuda

launches = 0  # kernel launches since the last reset (plain-path calls do not count)


def fused_layer_norm_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The Pallas kernel's function in plain PyTorch: f32 mean, f32 variance
    of ``x - mean``, ``rsqrt(var + eps)``, f32 affine, cast to x's dtype."""
    xf = x.float()
    d = xf - xf.mean(dim=-1, keepdim=True)
    var = (d * d).mean(dim=-1, keepdim=True)
    y = d * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def fused_layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis of a bf16 (..., C) tensor; K6 on the card."""
    if x.device.type == "cpu":
        return fused_layer_norm_plain(x, weight, bias, eps)
    name = "fused_layer_norm"
    check_dtype(name, torch.bfloat16, x)
    C = x.shape[-1] if x.dim() else 0
    if C == 0 or x.numel() == 0 or weight.shape != (C,) or bias.shape != (C,):
        raise ValueError(f"{name}: x {tuple(x.shape)} needs weight and bias of shape ({C},), "
                         f"got {tuple(weight.shape)} / {tuple(bias.shape)}")
    if weight.dtype != bias.dtype or weight.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{name}: weight and bias must both be bf16 or both float32, got {weight.dtype} / {bias.dtype}")
    check_on_cuda(name, x, weight, bias)
    return KernelForwardPlainGrad.apply(
        lambda x, w, b: _launch(x, w, b, eps), lambda x, w, b: fused_layer_norm_plain(x, w, b, eps), x, weight, bias
    )


def _launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    C = x.shape[-1]
    x2 = x.reshape(-1, C).contiguous()
    w, b = weight.detach().contiguous(), bias.detach().contiguous()  # no-ops for a model's parameters
    out = torch.empty_like(x2)
    err = _build.lib().srgpt_layer_norm(
        x2.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), x2.shape[0], C, float(eps),
        int(w.dtype == torch.float32), _build.stream_ptr(x),
    )
    _build.check(err, "fused_layer_norm")
    global launches
    launches += 1
    return out.reshape(x.shape)
