"""The composite in plain PyTorch: SigLIP tower (VILA's select_layer), the
region extractor (deconv refinement, mask pooling, RGB and depth
projectors), the mlp_downsample projector, the splice, and the Mistral /
Mixtral decoder (GQA, rotate-half RoPE, RMSNorm, sliding window, top-k MoE).

Every product is float32 on float32 operands (TF32 off), from the weights
as the benchmark made them: bf16 tensors widened, W8A8 tensors as q x
scale.  A W8A8 configuration's quantized linears also quantize their
input per row to int8, as its stated arithmetic does.  ``lowp`` computes
in a lower precision instead, the control of the comparison: ``"fp8"``
rounds every linear's weight per output channel and its input per row to
float8 e4m3 (scaled to its range), ``"w8a8"`` quantizes both to int8,
``"int4"`` both to int4.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IMAGE_TOKEN = -200
TOKENS_PER_IMAGE = 196


def fake_fp8(x: torch.Tensor) -> torch.Tensor:
    """Each row of x (last axis) scaled to float8 e4m3's range (448),
    rounded to it, and scaled back; the gradient passes straight through."""
    s = x.detach().abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).float() * s
    return x + (q - x.detach())


def fake_quant(x: torch.Tensor, levels: int) -> torch.Tensor:
    """Symmetric quantization of each row of x (last axis) to integers in
    [-levels, levels], returned dequantized; the gradient passes straight
    through."""
    amax = x.detach().abs().amax(dim=-1, keepdim=True).clamp(min=1e-12)
    s = amax / levels
    q = torch.clamp(torch.round(x.detach() / s), -levels, levels) * s
    return x + (q - x.detach())


class Composite:
    """The reference model over the tensors ``W`` (names as the benchmark's
    ``seeded.param_specs``) of configuration ``c``; ``trained`` overrides
    some of them (the train check's float32 parameters)."""

    def __init__(self, c: dict, W: Dict[str, torch.Tensor], lowp: Optional[str] = None,
                 trained: Optional[Dict[str, torch.Tensor]] = None):
        self.c, self.W, self.lowp = c, W, lowp
        self.trained = trained or {}

    # ---- tensors ---------------------------------------------------------
    def tensor(self, name: str) -> torch.Tensor:
        if name in self.trained:
            return self.trained[name]
        return self.W[name].float()

    def weight(self, name: str) -> torch.Tensor:
        """(out, in) float32 weight of the linear ``name``."""
        if name + ".q" in self.W:
            w = self.W[name + ".q"].float() * self.W[name + ".scale"][:, None]
        else:
            w = self.tensor(name + ".weight")
        if self.lowp == "w8a8":
            w = fake_quant(w, 127)
        elif self.lowp == "int4":
            w = fake_quant(w, 7)
        elif self.lowp == "fp8":
            w = fake_fp8(w)
        return w

    def linear(self, x: torch.Tensor, name: str, bias: bool = False) -> torch.Tensor:
        if self.lowp == "int4":
            x = fake_quant(x, 7)
        elif self.lowp == "w8a8" or name + ".q" in self.W:
            x = fake_quant(x, 127)
        elif self.lowp == "fp8":
            x = fake_fp8(x)
        y = x @ self.weight(name).t()
        return y + self.tensor(name + ".bias") if bias else y

    def layer_norm(self, x: torch.Tensor, name: str, eps: float) -> torch.Tensor:
        return F.layer_norm(x, x.shape[-1:], self.tensor(name + ".weight"), self.tensor(name + ".bias"), eps)

    # ---- vision tower ----------------------------------------------------
    def tower(self, px: torch.Tensor) -> torch.Tensor:
        """(N, S, S, 3) normalized pixels -> (N, T, C): the hidden states
        after layer ``num_hidden_layers + 1 + select_layer`` (all tokens)."""
        v = self.c["vision"]
        p = "vision_tower.vision_model."
        w = self.tensor(p + "embeddings.patch_embedding.weight")
        x = F.conv2d(px.float().permute(0, 3, 1, 2), w, self.tensor(p + "embeddings.patch_embedding.bias"),
                     stride=v["patch_size"])
        x = x.flatten(2).transpose(1, 2) + self.tensor(p + "embeddings.position_embedding.weight")
        n_layers = v["num_hidden_layers"] + 1 + v["select_layer"]
        heads, eps = v["num_attention_heads"], v["layer_norm_eps"]
        for i in range(n_layers):
            q = f"{p}encoder.layers.{i}."
            h = self.layer_norm(x, q + "layer_norm1", eps)
            N, T, C = h.shape
            qs, ks, vs = (self.linear(h, q + f"self_attn.{n}", True).view(N, T, heads, -1).transpose(1, 2)
                          for n in ("q_proj", "k_proj", "v_proj"))
            a = torch.softmax(qs @ ks.transpose(-1, -2) / math.sqrt(C // heads), dim=-1) @ vs
            x = x + self.linear(a.transpose(1, 2).reshape(N, T, C), q + "self_attn.out_proj", True)
            h = self.layer_norm(x, q + "layer_norm2", eps)
            h = F.gelu(self.linear(h, q + "mlp.fc1", True), approximate="tanh")
            x = x + self.linear(h, q + "mlp.fc2", True)
        return x

    # ---- region extractor and projector ----------------------------------
    def refine(self, feats: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, T, C) tower features -> (hres (N, C, h, w), lres (N, C, a, a)):
        (deconv + LayerNorm2d + GELU) x (depth - 1), deconv + GELU, then
        the adaptive average pool."""
        r = self.c["region"]
        N, T, C = feats.shape
        side = int(round(T**0.5))
        x = feats.transpose(1, 2).reshape(N, C, side, side)
        idx = 0
        for d in range(r["deconv_depth"]):
            m = f"region_extractor.feature_refinement_module.{idx}"
            x = F.conv_transpose2d(x, self.tensor(m + ".weight"), self.tensor(m + ".bias"), stride=2)
            idx += 1
            if d < r["deconv_depth"] - 1:
                x = self.layer_norm(x.permute(0, 2, 3, 1), f"region_extractor.feature_refinement_module.{idx}",
                                    r["layer_norm_eps"]).permute(0, 3, 1, 2)
                idx += 1
            x = F.gelu(x)
            idx += 1
        return x, F.adaptive_avg_pool2d(x, r["ada_pool_size"])

    @staticmethod
    def mask_pool(feats: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        """(N, C, h, w) features, (N, R, S, S) masks -> (N, R, C): the masks
        resized bilinearly to the grid, each normalized to sum 1."""
        m = F.interpolate(masks.float(), size=feats.shape[-2:], mode="bilinear", align_corners=False)
        m = m / (m.sum(dim=(-1, -2), keepdim=True) + 1e-8)
        return torch.einsum("nchw,nrhw->nrc", feats, m)

    def project(self, lres: torch.Tensor) -> torch.Tensor:
        """(N, C, a, a) -> (N, ceil(a / 2)^2, H): mlp_downsample's 2 x 2 fold
        (VILA's DownSampleBlock, odd grids zero-padded), LayerNorm, Linear,
        GELU, Linear."""
        x = lres.permute(0, 2, 3, 1)  # (N, a, a, C), row-major
        n, w, h, c = x.shape
        if w % 2:
            x = torch.cat([x, x.new_zeros((n, 1, h, c))], dim=1)
            w += 1
        if h % 2:
            x = torch.cat([x, x.new_zeros((n, w, 1, c))], dim=2)
            h += 1
        x = x.reshape(n, w, h // 2, c * 2).permute(0, 2, 1, 3).reshape(n, (h // 2) * (w // 2), c * 4)
        x = self.layer_norm(x, "mm_projector.layers.1", self.c["projector"]["layer_norm_eps"])
        x = F.gelu(self.linear(x, "mm_projector.layers.2", True))
        return self.linear(x, "mm_projector.layers.4", True)

    def encode(self, images: torch.Tensor, depths: torch.Tensor, masks: torch.Tensor,
               tower_grad: bool = False) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(image tokens (N, 196, H), mask embeds (N, R, H), depth embeds
        (N, R, H)): RGB regions pooled on the refined grid, depth regions on
        the raw depth features, image tokens from the projected pooled grid."""
        with torch.set_grad_enabled(tower_grad and torch.is_grad_enabled()):
            rgb, dep = self.tower(images), self.tower(depths)
        hres, lres = self.refine(rgb)
        N, T, C = dep.shape
        side = int(round(T**0.5))
        mask_emb = self.linear(self.mask_pool(hres, masks), "region_extractor.rgb_projector", True)
        dep_grid = dep.transpose(1, 2).reshape(N, C, side, side)
        depth_emb = self.linear(self.mask_pool(dep_grid, masks), "region_extractor.depth_projector", True)
        return self.project(lres), mask_emb, depth_emb

    # ---- splice ----------------------------------------------------------
    def splice(self, ids: Sequence[int], image: torch.Tensor, mask_emb: torch.Tensor,
               depth_emb: torch.Tensor) -> torch.Tensor:
        """(L, H): the image placeholder becomes the image's tokens, the k-th
        <mask> / <depth> the k-th region's embeds, other ids their
        embedding rows."""
        c = self.c
        table = self.W["llm.model.embed_tokens.weight"]
        parts, text, n_mask, n_depth = [], [], 0, 0

        def flush():
            if text:
                parts.append(table[torch.as_tensor(text, device=table.device)].float())
                text.clear()

        for t in ids:
            if t == IMAGE_TOKEN:
                flush()
                parts.append(image)
            elif t == c["mask_token_id"]:
                flush()
                parts.append(mask_emb[n_mask : n_mask + 1])
                n_mask += 1
            elif t == c["depth_token_id"]:
                flush()
                parts.append(depth_emb[n_depth : n_depth + 1])
                n_depth += 1
            else:
                text.append(int(t))
        flush()
        return torch.cat(parts)

    # ---- decoder ---------------------------------------------------------
    def rms_norm(self, x: torch.Tensor, name: str) -> torch.Tensor:
        x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.c["rms_norm_eps"])
        return x * self.tensor(name + ".weight")

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (B, h, L, D) rotated by rotate_half at positions pos (B, L)."""
        D = x.shape[-1]
        inv = 1.0 / (self.c["rope_theta"] ** (torch.arange(0, D, 2, device=x.device, dtype=torch.float64) / D))
        ang = (pos.double()[..., None] * inv).float()
        emb = torch.cat([ang, ang], dim=-1)[:, None]
        rot = torch.cat([-x[..., D // 2 :], x[..., : D // 2]], dim=-1)
        return x * emb.cos() + rot * emb.sin()

    def attention(self, x: torch.Tensor, i: int, pos: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        c = self.c
        B, L, H = x.shape
        Hq, Hk, D = c["num_attention_heads"], c["num_key_value_heads"], c["head_dim"]
        p = f"llm.model.layers.{i}.self_attn."
        q = self.linear(x, p + "q_proj").view(B, L, Hq, D).transpose(1, 2)
        k = self.linear(x, p + "k_proj").view(B, L, Hk, D).transpose(1, 2)
        v = self.linear(x, p + "v_proj").view(B, L, Hk, D).transpose(1, 2)
        q, k = self.rope(q, pos), self.rope(k, pos)
        k, v = (t.repeat_interleave(Hq // Hk, dim=1) for t in (k, v))
        idx = torch.arange(L, device=x.device)
        allow = (idx[None, :] <= idx[:, None])[None] & (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0)
        if c.get("sliding_window"):
            allow = allow & (idx[:, None] - idx[None, :] < c["sliding_window"])[None]
        s = (q @ k.transpose(-1, -2)) / math.sqrt(D)
        s = s.masked_fill(~allow[:, None], torch.finfo(s.dtype).min)  # a padded query sees nothing: uniform, finite
        a = torch.softmax(s, dim=-1) @ v
        return self.linear(a.transpose(1, 2).reshape(B, L, Hq * D), p + "o_proj")

    def ffn(self, x: torch.Tensor, i: int) -> torch.Tensor:
        c = self.c
        p = f"llm.model.layers.{i}."
        E = c.get("num_local_experts", 0)
        if not E:
            return self.linear(F.silu(self.linear(x, p + "mlp.gate_proj")) * self.linear(x, p + "mlp.up_proj"),
                               p + "mlp.down_proj")
        m = p + "block_sparse_moe."
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        probs = torch.softmax(self.linear(x, m + "gate"), dim=-1)
        top_p, top_e = torch.topk(probs, c["num_experts_per_tok"], dim=-1)
        gates = top_p / top_p.sum(dim=-1, keepdim=True)
        out = torch.zeros_like(x)
        for e in range(E):
            rows, slot = torch.nonzero(top_e == e, as_tuple=True)
            if rows.numel() == 0:
                continue
            xe = x[rows]
            ye = self.linear(F.silu(self.linear(xe, f"{m}experts.{e}.w1")) * self.linear(xe, f"{m}experts.{e}.w3"),
                             f"{m}experts.{e}.w2")
            out = out.index_add(0, rows, ye * gates[rows, slot][:, None])
        return out.reshape(shape)

    def layer(self, x: torch.Tensor, i: int, pos: torch.Tensor, seg: torch.Tensor) -> torch.Tensor:
        p = f"llm.model.layers.{i}."
        x = x + self.attention(self.rms_norm(x, p + "input_layernorm"), i, pos, seg)
        return x + self.ffn(self.rms_norm(x, p + "post_attention_layernorm"), i)

    def decode_stack(self, x: torch.Tensor, pos: torch.Tensor, seg: torch.Tensor, remat: bool = False) -> torch.Tensor:
        """(B, L, H) embeddings -> the final-normed hidden states."""
        for i in range(self.c["num_hidden_layers"]):
            if remat and torch.is_grad_enabled():
                x = checkpoint(self.layer, x, i, pos, seg, use_reentrant=False)
            else:
                x = self.layer(x, i, pos, seg)
        return self.rms_norm(x, "llm.model.norm")

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self.linear(h, "llm.lm_head")


def pad_rows(rows: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(L_i, H) sequences -> (x (B, L, H), positions (B, L), segments (B, L):
    1 on the live positions, 0 on the padding)."""
    L = max(r.shape[0] for r in rows)
    B, H = len(rows), rows[0].shape[1]
    x = rows[0].new_zeros((B, L, H))
    seg = torch.zeros((B, L), dtype=torch.int64, device=x.device)
    for b, r in enumerate(rows):
        x[b, : r.shape[0]] = r
        seg[b, : r.shape[0]] = 1
    pos = torch.arange(L, device=x.device).expand(B, L)
    return x, pos, seg


def plain_precision() -> None:
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
