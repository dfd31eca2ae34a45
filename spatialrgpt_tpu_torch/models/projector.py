"""Multimodal projector, ``mlp_downsample`` variant (port of
``spatialrgpt_tpu/models/projector.py``).

``flat_square`` packs 2x2 neighbouring patches into channels with the
reference's exact (row-pair, column) interleave, so 27x27 tokens (zero-
padded to 28x28) become 14x14; then LayerNorm (eps 1e-5) -> Linear ->
exact GELU -> Linear.  Parameters under the reference's names
``layers.{1,2,4}.*``.
"""

from __future__ import annotations

import torch
from torch import nn

from spatialrgpt_tpu_torch.config import ProjectorConfig
from spatialrgpt_tpu_torch.ops.layers import gelu_erf, layer_norm, linear


class MultimodalProjector(nn.Module):
    def __init__(self, cfg: ProjectorConfig, dtype=None):
        super().__init__()
        if cfg.projector_type != "mlp_downsample":
            raise NotImplementedError(f"projector type {cfg.projector_type} is not ported")
        c4, h = cfg.mm_hidden_size * 4, cfg.hidden_size
        self.layers = nn.ModuleList(
            [
                nn.Identity(),  # DownSampleBlock (flat_square), no parameters
                nn.LayerNorm(c4, eps=1e-5, dtype=dtype),
                nn.Linear(c4, h, dtype=dtype),
                nn.GELU(),
                nn.Linear(h, h, dtype=dtype),
            ]
        )


def flat_square(x: torch.Tensor) -> torch.Tensor:
    """(N, W, H, C) -> (N, H/2, W/2, 4C), zero-padding odd W/H by one."""
    n, w, h, c = x.shape
    if w % 2 == 1:
        x = torch.cat([x, x.new_zeros((n, 1, h, c))], dim=1)
        w += 1
    if h % 2 == 1:
        x = torch.cat([x, x.new_zeros((n, w, 1, c))], dim=2)
        h += 1
    x = x.reshape(n, w, h // 2, c * 2)
    x = x.permute(0, 2, 1, 3)
    return x.reshape(n, h // 2, w // 2, c * 4)


def forward(module: MultimodalProjector, x: torch.Tensor, cfg: ProjectorConfig) -> torch.Tensor:
    """x: (N, num_tokens, mm_hidden) -> (N, out_tokens, hidden)."""
    n, hw, c = x.shape
    side = int(round(hw**0.5))
    x = flat_square(x.reshape(n, side, side, c)).reshape(n, -1, c * 4)
    ln, fc1, fc2 = module.layers[1], module.layers[2], module.layers[4]
    x = layer_norm(x, ln.weight, ln.bias, eps=1e-5)
    x = gelu_erf(linear(x, fc1.weight, fc1.bias))
    return linear(x, fc2.weight, fc2.bias)
