"""RAM-style open-set image tagger, port of ``spatialrgpt_tpu/models/ram.py``:
the Swin-L backbone (``models/swin.py``) and a Q2L tagging head, per-tag
query embeddings through a small decoder (self-attention over the 4585
queries, cross-attention into the image tokens, an FFN), then a group-wise
linear in f32, one logit per tag; a tag fires where sigmoid(logit) reaches
its class threshold (RAM's default 0.68).

Parameters live in ``RamModel``: the backbone under HF ``SwinModel`` names
below ``swin.``, the head under the names of the reference's parameter
tree.  Attention is plain PyTorch, as the reference's is XLA.
``process_tag_classes`` and ``preprocess_image`` are copies of the
reference's framework-free helpers; ``convert_ram`` raises as the
reference's does (the released checkpoint's head names are not pinned).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from spatialrgpt_tpu_torch.models import swin as swin_mod
from spatialrgpt_tpu_torch.ops.layers import gelu_erf, layer_norm, linear
from spatialrgpt_tpu_torch.utils.device import card_device

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)  # ram.py:60 transform
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


@dataclass(frozen=True)
class RamConfig:
    swin: swin_mod.SwinConfig = swin_mod.SWIN_L_384
    num_tags: int = 4585  # RAM tag vocabulary size
    hidden_size: int = 768  # tagging-head width
    num_decoder_layers: int = 2
    num_heads: int = 4
    default_threshold: float = 0.68
    layer_norm_eps: float = 1e-12


class _MHA(nn.Module):
    def __init__(self, d: int, dtype=None):
        super().__init__()
        self.q = nn.Linear(d, d, dtype=dtype)
        self.k = nn.Linear(d, d, dtype=dtype)
        self.v = nn.Linear(d, d, dtype=dtype)
        self.proj = nn.Linear(d, d, dtype=dtype)


class _MLP(nn.Module):
    def __init__(self, d: int, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(d, 4 * d, dtype=dtype)
        self.fc2 = nn.Linear(4 * d, d, dtype=dtype)


class _DecoderLayer(nn.Module):
    def __init__(self, cfg: RamConfig, dtype=None):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.ln_self = nn.LayerNorm(d, eps=eps, dtype=dtype)
        self.self_attn = _MHA(d, dtype)
        self.ln_cross = nn.LayerNorm(d, eps=eps, dtype=dtype)
        self.cross_attn = _MHA(d, dtype)
        self.ln_mlp = nn.LayerNorm(d, eps=eps, dtype=dtype)
        self.mlp = _MLP(d, dtype)


class RamModel(nn.Module):
    def __init__(self, cfg: RamConfig, dtype=None):
        super().__init__()
        d = cfg.hidden_size
        self.swin = swin_mod.SwinModel(cfg.swin, dtype)
        self.vision_proj = nn.Linear(cfg.swin.num_features, d, dtype=dtype)
        self.tag_embed = nn.Parameter(torch.empty(cfg.num_tags, d, dtype=dtype))
        self.decoder = nn.ModuleList(_DecoderLayer(cfg, dtype) for _ in range(cfg.num_decoder_layers))
        self.final_norm = nn.LayerNorm(d, eps=cfg.layer_norm_eps, dtype=dtype)
        self.fc_w = nn.Parameter(torch.empty(cfg.num_tags, d, dtype=dtype))
        self.fc_b = nn.Parameter(torch.empty(cfg.num_tags, dtype=dtype))


def _mha(q_in: torch.Tensor, kv_in: torch.Tensor, p: _MHA, num_heads: int) -> torch.Tensor:
    Bq, Tq, C = q_in.shape
    Tk = kv_in.shape[1]
    d = C // num_heads
    q = linear(q_in, p.q).view(Bq, Tq, num_heads, d).transpose(1, 2)
    k = linear(kv_in, p.k).view(Bq, Tk, num_heads, d).transpose(1, 2)
    v = linear(kv_in, p.v).view(Bq, Tk, num_heads, d).transpose(1, 2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
    pr = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(pr, v).transpose(1, 2).reshape(Bq, Tq, C)
    return linear(o, p.proj)


def forward(model: RamModel, pixel_values: torch.Tensor, cfg: RamConfig) -> torch.Tensor:
    """pixel_values (B, S, S, 3) normalized -> per-tag logits (B, num_tags) f32."""
    eps = cfg.layer_norm_eps

    def ln(x, norm):
        return layer_norm(x, norm.weight, norm.bias, eps)

    feats = linear(swin_mod.forward(model.swin, pixel_values, cfg.swin), model.vision_proj)  # (B, L, D)
    q = model.tag_embed.to(feats.dtype)[None].expand(feats.shape[0], -1, -1)  # (B, num_tags, D)
    for lp in model.decoder:
        h = ln(q, lp.ln_self)  # the reference normalizes twice, for the queries and the keys: one value
        q = q + _mha(h, h, lp.self_attn, cfg.num_heads)
        q = q + _mha(ln(q, lp.ln_cross), feats, lp.cross_attn, cfg.num_heads)
        h = ln(q, lp.ln_mlp)
        q = q + linear(gelu_erf(linear(h, lp.mlp.fc1)), lp.mlp.fc2)
    q = ln(q, model.final_norm)
    # group-wise linear: one weight vector + bias per tag
    return torch.einsum("bnd,nd->bn", q.float(), model.fc_w.float()) + model.fc_b.float()


# ---------------------------------------------------------------------------
# Tag post-processing (reference wrappers/ram.py semantics)
# ---------------------------------------------------------------------------


def process_tag_classes(
    tags: Sequence[str],
    add_classes: Sequence[str] = (),
    remove_classes: Sequence[str] = (),
) -> List[str]:
    """Reference ``process_tag_classes`` (wrappers/ram.py:34-46): strip,
    drop empties, append missing add_classes, remove by substring match."""
    classes = [c.strip() for c in tags]
    classes = [c for c in classes if c != ""]
    for c in add_classes:
        if c not in classes:
            classes.append(c)
    for c in remove_classes:
        classes = [obj for obj in classes if c not in obj.lower()]
    return classes


def preprocess_image(image: np.ndarray, size: int = 384) -> np.ndarray:
    """uint8/float RGB (H, W, 3) -> normalized (size, size, 3) float32
    (resize + ImageNet normalize, reference ram.py:58-63)."""
    from PIL import Image

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * (255.0 if img.max() <= 1.5 else 1.0), 0, 255).astype(np.uint8)
    img = np.asarray(Image.fromarray(img).resize((size, size), Image.BILINEAR), np.float32)
    img = img / 255.0
    return (img - IMAGENET_MEAN) / IMAGENET_STD


def make_tagger(
    model: RamModel,
    cfg: RamConfig,
    tag_list: Sequence[str],
    thresholds: Optional[np.ndarray] = None,
    add_classes: Sequence[str] = (),
    remove_classes: Sequence[str] = (),
    bg_classes: Sequence[str] = (),
    rm_bg_classes: bool = True,
    device=None,
) -> Callable[[np.ndarray], List[str]]:
    """``tagger(image) -> [class names]`` for ``synth.pipeline.SegmentStage``,
    the reference's ``run_tagging_model`` (wrappers/ram.py:11-31): threshold
    per tag, then the add / remove post-processing (background classes
    removed by default).  The model runs on ``device`` (default: the card;
    without one the call raises)."""
    if len(tag_list) != cfg.num_tags:
        raise ValueError(f"{len(tag_list)} tags for a head of {cfg.num_tags}")
    dev = card_device(device, "make_tagger")
    model.to(dev)
    th = np.full((cfg.num_tags,), cfg.default_threshold, np.float32) if thresholds is None else np.asarray(thresholds, np.float32)
    removes = list(remove_classes) + (list(bg_classes) if rm_bg_classes else [])

    def tagger(image: np.ndarray) -> List[str]:
        x = torch.as_tensor(preprocess_image(image, cfg.swin.image_size)[None], device=dev)
        with torch.no_grad():
            logits = forward(model, x, cfg)[0].cpu().numpy()
        probs = 1.0 / (1.0 + np.exp(-logits))
        fired = [tag_list[i] for i in range(cfg.num_tags) if probs[i] >= th[i]]
        return process_tag_classes(fired, add_classes=add_classes, remove_classes=removes)

    return tagger


def convert_ram(sd, cfg: RamConfig, device, dtype=torch.float32) -> RamModel:
    """The released checkpoint's converter, which raises as the reference's
    does: the Swin backbone would load through ``swin.convert_swin`` once
    its keys are renamed to the HF layout, but the head tensors
    (label_embed / wordvec_proj / tagging_head / fc) must be pinned against
    a real ram_swin_large_14m.pth, which is not available."""
    raise NotImplementedError(
        "RAM released-weight conversion requires the checkpoint file to pin names; "
        "architecture + tagger behavior are tested with random weights"
    )
