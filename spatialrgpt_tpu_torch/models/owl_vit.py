"""OWL-ViT open-vocabulary detector, port of
``spatialrgpt_tpu/models/owl_vit.py``: a CLIP ViT whose patch tokens, each
merged with the class token, predict one box (a grid-biased cxcywh head with
erf GELU) and a class logit per text query (cosine similarity with a learned
shift and an ELU scale); the text tower runs with a causal and a padding
bias and pools at the end-of-text token.

Parameters live in ``OwlViTModel`` under the HF ``OwlViTForObjectDetection``
names that the reference's ``convert_owlvit`` reads, so ``convert_owlvit``
here loads an HF state dict of tensors as it is, without ``transformers``.
The forward functions are plain functions over that module in the
reference's NHWC layout and dtype flow; attention is plain PyTorch, as the
reference's is XLA.  ``box_bias`` and ``preprocess_image`` are copies of
the reference's framework-free helpers.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from spatialrgpt_tpu_torch.ops.layers import gelu_erf, layer_norm, linear
from spatialrgpt_tpu_torch.utils.device import card_device


@dataclass(frozen=True)
class OwlViTVisionConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    image_size: int = 768
    patch_size: int = 32
    layer_norm_eps: float = 1e-5

    @property
    def num_patches_side(self) -> int:
        return self.image_size // self.patch_size


@dataclass(frozen=True)
class OwlViTTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    intermediate_size: int = 2048
    max_position_embeddings: int = 16
    layer_norm_eps: float = 1e-5


@dataclass(frozen=True)
class OwlViTConfig:
    vision: OwlViTVisionConfig = OwlViTVisionConfig()
    text: OwlViTTextConfig = OwlViTTextConfig()
    projection_dim: int = 512


# ---------------------------------------------------------------------------
# module tree (parameter storage under the HF OwlViTForObjectDetection names)
# ---------------------------------------------------------------------------


class _SelfAttention(nn.Module):
    def __init__(self, c: int, dtype=None):
        super().__init__()
        self.q_proj = nn.Linear(c, c, dtype=dtype)
        self.k_proj = nn.Linear(c, c, dtype=dtype)
        self.v_proj = nn.Linear(c, c, dtype=dtype)
        self.out_proj = nn.Linear(c, c, dtype=dtype)


class _MLP(nn.Module):
    def __init__(self, c: int, inter: int, dtype=None):
        super().__init__()
        self.fc1 = nn.Linear(c, inter, dtype=dtype)
        self.fc2 = nn.Linear(inter, c, dtype=dtype)


class _ClipLayer(nn.Module):
    def __init__(self, c: int, inter: int, eps: float, dtype=None):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(c, eps=eps, dtype=dtype)
        self.self_attn = _SelfAttention(c, dtype)
        self.layer_norm2 = nn.LayerNorm(c, eps=eps, dtype=dtype)
        self.mlp = _MLP(c, inter, dtype)


class _Encoder(nn.Module):
    def __init__(self, n: int, c: int, inter: int, eps: float, dtype=None):
        super().__init__()
        self.layers = nn.ModuleList(_ClipLayer(c, inter, eps, dtype) for _ in range(n))


class _VisionEmbeddings(nn.Module):
    def __init__(self, v: OwlViTVisionConfig, dtype=None):
        super().__init__()
        # parameter storage only: the forward is unfold + matmul (``encode_image``)
        self.patch_embedding = nn.Conv2d(3, v.hidden_size, v.patch_size, stride=v.patch_size, bias=False, dtype=dtype)
        self.class_embedding = nn.Parameter(torch.empty(v.hidden_size, dtype=dtype))
        self.position_embedding = nn.Embedding(v.num_patches_side**2 + 1, v.hidden_size, dtype=dtype)


class _VisionModel(nn.Module):
    def __init__(self, v: OwlViTVisionConfig, dtype=None):
        super().__init__()
        c, eps = v.hidden_size, v.layer_norm_eps
        self.embeddings = _VisionEmbeddings(v, dtype)
        self.pre_layernorm = nn.LayerNorm(c, eps=eps, dtype=dtype)
        self.encoder = _Encoder(v.num_hidden_layers, c, v.intermediate_size, eps, dtype)
        self.post_layernorm = nn.LayerNorm(c, eps=eps, dtype=dtype)


class _TextEmbeddings(nn.Module):
    def __init__(self, t: OwlViTTextConfig, dtype=None):
        super().__init__()
        self.token_embedding = nn.Embedding(t.vocab_size, t.hidden_size, dtype=dtype)
        self.position_embedding = nn.Embedding(t.max_position_embeddings, t.hidden_size, dtype=dtype)


class _TextModel(nn.Module):
    def __init__(self, t: OwlViTTextConfig, dtype=None):
        super().__init__()
        c, eps = t.hidden_size, t.layer_norm_eps
        self.embeddings = _TextEmbeddings(t, dtype)
        self.encoder = _Encoder(t.num_hidden_layers, c, t.intermediate_size, eps, dtype)
        self.final_layer_norm = nn.LayerNorm(c, eps=eps, dtype=dtype)


class _Owl(nn.Module):
    def __init__(self, cfg: OwlViTConfig, dtype=None):
        super().__init__()
        self.vision_model = _VisionModel(cfg.vision, dtype)
        self.text_model = _TextModel(cfg.text, dtype)
        self.text_projection = nn.Linear(cfg.text.hidden_size, cfg.projection_dim, bias=False, dtype=dtype)


class _ClassHead(nn.Module):
    def __init__(self, cfg: OwlViTConfig, dtype=None):
        super().__init__()
        w = cfg.vision.hidden_size
        self.dense0 = nn.Linear(w, cfg.text.hidden_size, dtype=dtype)
        self.logit_shift = nn.Linear(w, 1, dtype=dtype)
        self.logit_scale = nn.Linear(w, 1, dtype=dtype)


class _BoxHead(nn.Module):
    def __init__(self, cfg: OwlViTConfig, dtype=None):
        super().__init__()
        w = cfg.vision.hidden_size
        self.dense0 = nn.Linear(w, w, dtype=dtype)
        self.dense1 = nn.Linear(w, w, dtype=dtype)
        self.dense2 = nn.Linear(w, 4, dtype=dtype)


class OwlViTModel(nn.Module):
    def __init__(self, cfg: OwlViTConfig, dtype=None):
        super().__init__()
        self.owlvit = _Owl(cfg, dtype)
        self.layer_norm = nn.LayerNorm(cfg.vision.hidden_size, eps=cfg.vision.layer_norm_eps, dtype=dtype)
        self.class_head = _ClassHead(cfg, dtype)
        self.box_head = _BoxHead(cfg, dtype)


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def _ln(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    return layer_norm(x, norm.weight, norm.bias, norm.eps)


def _mha(x: torch.Tensor, p: _SelfAttention, num_heads: int, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard MHA over (B, T, C); ``bias`` is an additive (B|1, 1|H, T, T)."""
    B, T, C = x.shape
    d = C // num_heads
    q = linear(x, p.q_proj).view(B, T, num_heads, d).transpose(1, 2)
    k = linear(x, p.k_proj).view(B, T, num_heads, d).transpose(1, 2)
    v = linear(x, p.v_proj).view(B, T, num_heads, d).transpose(1, 2)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (d**-0.5)
    if bias is not None:
        s = s + bias
    pr = torch.softmax(s, dim=-1).to(v.dtype)
    o = torch.matmul(pr, v).transpose(1, 2).reshape(B, T, C)
    return linear(o, p.out_proj)


def _clip_layer(x: torch.Tensor, p: _ClipLayer, num_heads: int, bias=None) -> torch.Tensor:
    x = x + _mha(_ln(x, p.layer_norm1), p.self_attn, num_heads, bias)
    h = _ln(x, p.layer_norm2)
    return x + linear(quick_gelu(linear(h, p.mlp.fc1)), p.mlp.fc2)


def encode_image(model: OwlViTModel, pixel_values: torch.Tensor, cfg: OwlViTConfig) -> torch.Tensor:
    """pixel_values (B, S, S, 3) -> merged patch features (B, P, width)
    (CLS-token-modulated grid, post-LN: modeling_owlvit image_embedder)."""
    v = cfg.vision
    vm = model.owlvit.vision_model
    emb = vm.embeddings
    w = emb.patch_embedding.weight  # (C, 3, P, P)
    C, P = w.shape[0], v.patch_size
    B, H, W, _ = pixel_values.shape
    gh, gw = H // P, W // P
    # the stride equals the kernel ("VALID"): the patch conv is a matmul of the patches
    x = pixel_values[:, : gh * P, : gw * P].to(w.dtype).reshape(B, gh, P, gw, P, 3).permute(0, 1, 3, 2, 4, 5)
    x = torch.matmul(x.reshape(B, gh * gw, P * P * 3), w.permute(2, 3, 1, 0).reshape(P * P * 3, C))
    cls = emb.class_embedding.to(x.dtype)[None, None].expand(B, 1, C)
    x = torch.cat([cls, x], dim=1) + emb.position_embedding.weight[None].to(x.dtype)
    x = _ln(x, vm.pre_layernorm)
    for lp in vm.encoder.layers:
        x = _clip_layer(x, lp, v.num_attention_heads)
    x = _ln(x, vm.post_layernorm)
    # merge the class token into every patch, then the detection LN
    return _ln(x[:, 1:] * x[:, :1], model.layer_norm)


def encode_text(model: OwlViTModel, input_ids: torch.Tensor, attention_mask: torch.Tensor,
                cfg: OwlViTConfig) -> torch.Tensor:
    """(Q, T) ids + mask -> normalized projected query embeds (Q, proj)."""
    t = cfg.text
    tm = model.owlvit.text_model
    Q, T = input_ids.shape
    x = tm.embeddings.token_embedding.weight[input_ids] + tm.embeddings.position_embedding.weight[None, :T]
    neg = torch.finfo(torch.float32).min
    ar = torch.arange(T, device=input_ids.device)
    causal = torch.where(ar[:, None] >= ar[None, :], 0.0, neg)
    pad = torch.where(attention_mask[:, None, None, :] != 0, 0.0, neg)
    bias = causal[None, None] + pad  # both: -inf in f32, as the reference's sum
    for lp in tm.encoder.layers:
        x = _clip_layer(x, lp, t.num_attention_heads, bias)
    x = _ln(x, tm.final_layer_norm)
    pooled = x[torch.arange(Q, device=x.device), torch.argmax(input_ids, dim=-1)]
    emb = linear(pooled, model.owlvit.text_projection)
    return emb / torch.linalg.vector_norm(emb.float(), dim=-1, keepdim=True).to(emb.dtype)


# ---------------------------------------------------------------------------
# Detection heads
# ---------------------------------------------------------------------------


def box_bias(side: int) -> np.ndarray:
    """(P, 4) grid logit bias (modeling_owlvit compute_box_bias)."""
    coords = np.stack(
        np.meshgrid(np.arange(1, side + 1), np.arange(1, side + 1), indexing="xy"), axis=-1
    ).astype(np.float32)
    coords /= side
    coords = np.clip(coords.reshape(-1, 2), 0.0, 1.0)
    coord_bias = np.log(coords + 1e-4) - np.log1p(-coords + 1e-4)
    size = np.full_like(coord_bias, 1.0 / side)
    size_bias = np.log(size + 1e-4) - np.log1p(-size + 1e-4)
    return np.concatenate([coord_bias, size_bias], axis=-1)


@functools.lru_cache(maxsize=None)
def _box_bias_on(side: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(box_bias(side), device=device)


def predict_boxes(model: OwlViTModel, image_feats: torch.Tensor, cfg: OwlViTConfig) -> torch.Tensor:
    """-> (B, P, 4) cxcywh in [0, 1], f32.  The box head uses exact (erf)
    GELU (modeling_owlvit's OwlViTBoxPredictionHead), unlike the towers'
    quick_gelu."""
    bh = model.box_head
    h = gelu_erf(linear(image_feats, bh.dense0))
    h = gelu_erf(linear(h, bh.dense1))
    h = linear(h, bh.dense2)
    return torch.sigmoid(h + _box_bias_on(cfg.vision.num_patches_side, h.device)[None])


def predict_classes(
    model: OwlViTModel,
    image_feats: torch.Tensor,  # (B, P, width)
    query_embeds: torch.Tensor,  # (Q, proj) normalized
    query_mask: Optional[torch.Tensor] = None,  # (Q,) bool
) -> torch.Tensor:
    """-> (B, P, Q) f32 logits (cosine similarity with the learned shift and scale)."""
    ch = model.class_head
    img = linear(image_feats, ch.dense0)
    img = img / (torch.linalg.vector_norm(img.float(), dim=-1, keepdim=True) + 1e-6).to(img.dtype)
    qe = query_embeds / (torch.linalg.vector_norm(query_embeds.float(), dim=-1, keepdim=True) + 1e-6).to(query_embeds.dtype)
    logits = torch.einsum("bpd,qd->bpq", img.float(), qe.float())
    shift = linear(image_feats, ch.logit_shift).float()
    scale = F.elu(linear(image_feats, ch.logit_scale).float()) + 1.0
    logits = (logits + shift) * scale
    if query_mask is not None:
        logits = torch.where(query_mask[None, None, :], logits, torch.finfo(torch.float32).min)
    return logits


@torch.no_grad()
def detect(
    model: OwlViTModel,
    cfg: OwlViTConfig,
    pixel_values: torch.Tensor,  # (B, S, S, 3)
    input_ids: torch.Tensor,  # (Q, T)
    attention_mask: torch.Tensor,  # (Q, T)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward: -> (pred_logits (B, P, Q), pred_boxes (B, P, 4))."""
    feats = encode_image(model, pixel_values, cfg)
    queries = encode_text(model, input_ids, attention_mask, cfg)
    logits = predict_classes(model, feats, queries, query_mask=input_ids[:, 0] > 0)
    return logits, predict_boxes(model, feats, cfg)


# ---------------------------------------------------------------------------
# Detector wrapper (GroundingDINO predict_with_classes contract)
# ---------------------------------------------------------------------------

OWLVIT_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
OWLVIT_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_image(image: np.ndarray, size: int) -> np.ndarray:
    from PIL import Image

    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img * (255.0 if img.max() <= 1.5 else 1.0), 0, 255).astype(np.uint8)
    img = np.asarray(Image.fromarray(img).resize((size, size), Image.BICUBIC), np.float32)
    return (img / 255.0 - OWLVIT_MEAN) / OWLVIT_STD


def make_detector(
    model: OwlViTModel,
    cfg: OwlViTConfig,
    tokenize: Callable[[List[str]], Tuple[np.ndarray, np.ndarray]],
    box_threshold: float = 0.25,
    max_queries: int = 32,
    prompt: str = "a photo of a {}",
    device=None,
) -> Callable[[np.ndarray, Sequence[str]], List[Tuple[str, np.ndarray, float]]]:
    """``detector(image, classes) -> [(label, xyxy, score)]`` for
    ``synth.pipeline.SegmentStage``, the reference's predict_with_classes
    contract (segment.py:66-71): per patch, class = argmax over queries,
    score = sigmoid(max logit), kept where score > box_threshold.

    ``tokenize`` maps prompt strings to (ids (Q, T), mask (Q, T)): the CLIP
    BPE of a checkpoint, or any stand-in.  Queries are padded to
    ``max_queries``, as the reference pads them.  The model runs on
    ``device`` (default: the card; without one the call raises)."""
    dev = card_device(device, "make_detector")
    model.to(dev)

    def detector(image: np.ndarray, classes: Sequence[str]):
        if not classes:
            return []
        classes = list(classes)[:max_queries]
        ids, mask = tokenize([prompt.format(c) for c in classes])
        padq = max_queries - ids.shape[0]
        ids = np.pad(ids, ((0, padq), (0, 0)))
        mask = np.pad(mask, ((0, padq), (0, 0)))
        x = torch.as_tensor(preprocess_image(image, cfg.vision.image_size)[None], device=dev)
        logits, boxes = detect(model, cfg, x, torch.as_tensor(ids, device=dev), torch.as_tensor(mask, device=dev))
        logits = logits[0].cpu().numpy()  # (P, Q)
        boxes = boxes[0].float().cpu().numpy()  # (P, 4) cxcywh
        probs = 1.0 / (1.0 + np.exp(-logits))
        best = probs.argmax(axis=-1)
        score = probs.max(axis=-1)
        H, W = np.asarray(image).shape[:2]
        out = []
        for pi in np.nonzero(score > box_threshold)[0]:
            ci = int(best[pi])
            if ci >= len(classes):
                continue
            cx, cy, w, h = boxes[pi]
            xyxy = np.array(
                [(cx - w / 2) * W, (cy - h / 2) * H, (cx + w / 2) * W, (cy + h / 2) * H],
                np.float32,
            )
            xyxy = np.clip(xyxy, 0, [W, H, W, H])
            out.append((classes[ci], xyxy, float(score[pi])))
        return out

    return detector


def convert_owlvit(sd, cfg: OwlViTConfig, device, dtype=torch.float32) -> OwlViTModel:
    """HF ``OwlViTForObjectDetection`` state dict (tensors or arrays) ->
    ``OwlViTModel`` on ``device``.  The module holds the HF names, so each
    tensor the reference's converter reads loads as it is; the rest of the
    HF dict (the CLIP contrastive head, ``position_ids``) is not read."""
    with torch.device("meta"):
        model = OwlViTModel(cfg, dtype)
    state = {name: torch.as_tensor(sd[name]).to(device=device, dtype=dtype) for name in model.state_dict()}
    model = model.to_empty(device=device).requires_grad_(False).eval()
    model.load_state_dict(state, strict=True)
    return model
