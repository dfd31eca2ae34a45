"""Everything a run makes from ``--seed``: the weights of a configuration and
the inputs of a traffic mix.

Weights are made on the device in the type they are served in, a flat
buffer per (dtype, distribution) filled by one generator call, each tensor
a view of its buffer at a 256-byte aligned offset.  The same (config, seed,
device) gives the same tensors, so the plain reference makes them again
after the program's state is freed instead of reading anything the
program holds.

Names are the HF names of the composite's split checkpoint (``llm.``,
``vision_tower.``, ``mm_projector.``, ``region_extractor.``).  A W8A8
configuration holds each linear of ``llm.`` and ``vision_tower.`` as
``<name>.q`` (int8, (out, in)) and ``<name>.scale`` (f32, (out,)).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

IMAGE_TOKEN = -200  # the LLaVA family's image placeholder id
IGNORE = -100  # labels that take no loss
ALIGN = 256  # bytes
# each buffer's size is a multiple of this, so that its segment of the
# card's caching allocator has no slack where a small tensor could land and
# pin the segment after the buffer is freed
SEGMENT = 2 << 20


class Param(NamedTuple):
    name: str
    shape: Tuple[int, ...]
    kind: str  # normal | ones | zeros | q | scale
    arg: float  # normal: std; scale: fan_in
    part: str  # vision | llm | trained


def _lin(out: list, name: str, o: int, i: int, part: str, bias: bool, quant: bool) -> None:
    if quant and part in ("llm", "vision"):
        out += [Param(name + ".q", (o, i), "q", 0.0, part), Param(name + ".scale", (o,), "scale", float(i), part)]
    else:
        out.append(Param(name + ".weight", (o, i), "normal", i**-0.5, part))
    if bias:
        out.append(Param(name + ".bias", (o,), "zeros", 0.0, part))


def _ln(out: list, name: str, n: int, part: str, bias: bool = True) -> None:
    out.append(Param(name + ".weight", (n,), "ones", 0.0, part))
    if bias:
        out.append(Param(name + ".bias", (n,), "zeros", 0.0, part))


def param_specs(c: dict) -> List[Param]:
    """Every tensor of the composite of config ``c``, in a fixed order."""
    quant = c.get("quantized") == "w8a8"
    out: List[Param] = []
    v = c["vision"]
    C, P = v["hidden_size"], v["patch_size"]
    n_pos = (v["image_size"] // P) ** 2
    vt = "vision_tower.vision_model."
    out.append(Param(vt + "embeddings.patch_embedding.weight", (C, 3, P, P), "normal", 0.02, "vision"))
    out.append(Param(vt + "embeddings.patch_embedding.bias", (C,), "zeros", 0.0, "vision"))
    out.append(Param(vt + "embeddings.position_embedding.weight", (n_pos, C), "normal", 0.02, "vision"))
    for i in range(v["num_hidden_layers"]):
        p = f"{vt}encoder.layers.{i}."
        _ln(out, p + "layer_norm1", C, "vision")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _lin(out, p + "self_attn." + proj, C, C, "vision", True, quant)
        _ln(out, p + "layer_norm2", C, "vision")
        _lin(out, p + "mlp.fc1", v["intermediate_size"], C, "vision", True, quant)
        _lin(out, p + "mlp.fc2", C, v["intermediate_size"], "vision", True, quant)
    _ln(out, vt + "post_layernorm", C, "vision")
    H = c["hidden_size"]
    _ln(out, "mm_projector.layers.1", 4 * C, "trained")
    _lin(out, "mm_projector.layers.2", H, 4 * C, "trained", True, quant)
    _lin(out, "mm_projector.layers.4", H, H, "trained", True, quant)
    depth = c["region"]["deconv_depth"]
    idx = 0
    for d in range(depth):
        out.append(Param(f"region_extractor.feature_refinement_module.{idx}.weight", (C, C, 2, 2), "normal", C**-0.5,
                         "trained"))
        out.append(Param(f"region_extractor.feature_refinement_module.{idx}.bias", (C,), "zeros", 0.0, "trained"))
        idx += 1
        if d < depth - 1:
            _ln(out, f"region_extractor.feature_refinement_module.{idx}", C, "trained")
            idx += 1
        idx += 1  # GELU
    _lin(out, "region_extractor.rgb_projector", H, C, "trained", True, quant)
    _lin(out, "region_extractor.depth_projector", H, C, "trained", True, quant)
    V = c["vocab_size"] + c.get("num_extra_tokens", 0)
    D, Hq, Hk, I = c["head_dim"], c["num_attention_heads"], c["num_key_value_heads"], c["intermediate_size"]
    out.append(Param("llm.model.embed_tokens.weight", (V, H), "normal", 0.02, "llm"))
    for i in range(c["num_hidden_layers"]):
        p = f"llm.model.layers.{i}."
        _lin(out, p + "self_attn.q_proj", Hq * D, H, "llm", False, quant)
        _lin(out, p + "self_attn.k_proj", Hk * D, H, "llm", False, quant)
        _lin(out, p + "self_attn.v_proj", Hk * D, H, "llm", False, quant)
        _lin(out, p + "self_attn.o_proj", H, Hq * D, "llm", False, quant)
        E = c.get("num_local_experts", 0)
        if E:
            m = p + "block_sparse_moe."
            _lin(out, m + "gate", E, H, "llm", False, quant)
            for e in range(E):
                _lin(out, f"{m}experts.{e}.w1", I, H, "llm", False, quant)
                _lin(out, f"{m}experts.{e}.w3", I, H, "llm", False, quant)
                _lin(out, f"{m}experts.{e}.w2", H, I, "llm", False, quant)
        else:
            _lin(out, p + "mlp.gate_proj", I, H, "llm", False, quant)
            _lin(out, p + "mlp.up_proj", I, H, "llm", False, quant)
            _lin(out, p + "mlp.down_proj", H, I, "llm", False, quant)
        _ln(out, p + "input_layernorm", H, "llm", bias=False)
        _ln(out, p + "post_attention_layernorm", H, "llm", bias=False)
    _ln(out, "llm.model.norm", H, "llm", bias=False)
    _lin(out, "llm.lm_head", V, H, "llm", False, quant)
    return out


def _dtype(p: Param, trained_dtype: torch.dtype) -> torch.dtype:
    if p.kind == "q":
        return torch.int8
    if p.kind == "scale":
        return torch.float32
    return trained_dtype if p.part == "trained" else torch.bfloat16


@torch.no_grad()
def make_weights(c: dict, seed: int, device, trained_dtype: torch.dtype = torch.bfloat16) -> Dict[str, torch.Tensor]:
    """The composite's tensors from ``seed`` on ``device`` (see the module
    docstring); ``trained_dtype`` for the modules a train step tunes."""
    specs = param_specs(c)
    groups: Dict[tuple, list] = {}
    for p in specs:
        dt = _dtype(p, trained_dtype)
        key = (dt, p.kind, p.arg if p.kind == "normal" else 0.0)
        groups.setdefault(key, []).append(p)
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63 - 1))
    out: Dict[str, torch.Tensor] = {}
    for (dt, kind, arg), members in groups.items():
        size = torch.tensor([], dtype=dt).element_size()
        unit = ALIGN // size
        sizes = [int(np.prod(p.shape)) for p in members]
        offsets, n = [], 0
        for s in sizes:
            offsets.append(n)
            n += -(-s // unit) * unit
        n = -(-n * size // SEGMENT) * SEGMENT // size
        buf = torch.empty(n, dtype=dt, device=device)
        if kind == "normal":
            buf.normal_(0.0, arg, generator=g)
        elif kind == "q":
            buf.random_(-127, 128, generator=g)
        elif kind == "scale":
            buf.uniform_(0.75, 1.25, generator=g)
        elif kind == "ones":
            buf.fill_(1.0)
        else:
            buf.zero_()
        for p, off, s in zip(members, offsets, sizes):
            t = buf[off : off + s].view(p.shape)
            if kind == "scale":
                t.mul_(p.arg**-0.5 * 3**0.5 / 127.0)  # uniform q times this has the std fan_in^-1/2
            out[p.name] = t
    return out


# ---------------------------------------------------------------------------
# traffic
# ---------------------------------------------------------------------------


def deck(rng: np.random.Generator, low: int, high: int, n: int) -> np.ndarray:
    """``n`` draws from the integers low..high (inclusive), each pass over
    them a fresh permutation: every seed serves the same sizes in another
    order."""
    values = np.arange(low, high + 1)
    passes = [rng.permutation(values) for _ in range(-(-n // len(values)))]
    return np.concatenate(passes)[:n]


def spread(rng: np.random.Generator, low: int, high: int, n: int) -> np.ndarray:
    """``n`` sizes evenly spaced over low..high, in an order drawn from
    ``rng``: the same multiset for every seed."""
    return rng.permutation(np.round(np.linspace(low, high, n)).astype(np.int64))


def prompt_ids(c: dict, rng: np.random.Generator, n_text: int, regions: int) -> List[int]:
    """bos, the image, (<mask>, <depth>) per region, then ``n_text`` question
    tokens drawn from the base vocabulary."""
    ids = [c["bos_token_id"], IMAGE_TOKEN] + [c["mask_token_id"], c["depth_token_id"]] * regions
    return ids + rng.integers(3, c["vocab_size"], n_text).tolist()


def box_masks(boxes: torch.Tensor, size: int) -> torch.Tensor:
    """(..., 4) boxes (x0, y0, x1, y1), end exclusive -> (..., size, size)
    float masks, 1 inside."""
    r = torch.arange(size, device=boxes.device)
    ys = (r >= boxes[..., 1:2]) & (r < boxes[..., 3:4])
    xs = (r >= boxes[..., 0:1]) & (r < boxes[..., 2:3])
    return (ys[..., :, None] & xs[..., None, :]).float()


def draw_boxes(rng: np.random.Generator, n: int, regions: int, size: int, low: int, high: int) -> np.ndarray:
    """(n, regions, 4) boxes of sides in low..high inside the image."""
    w = rng.integers(low, high + 1, (n, regions, 2))
    x0 = (rng.random((n, regions, 2)) * (size - w + 1)).astype(np.int64)
    return np.concatenate([x0, x0 + w], axis=-1)


@torch.no_grad()
def pixels(seed: int, n: int, size: int, device, salt: int) -> torch.Tensor:
    """(n, size, size, 3) bf16 pixels: uint8 values drawn on the device,
    then SigLIP's rescale and normalize ((x / 255 - 0.5) / 0.5), as a
    client's processor hands them to the server."""
    g = torch.Generator(device=device).manual_seed((int(seed) * 7919 + salt) % (2**63 - 1))
    u8 = torch.randint(0, 256, (n, size, size, 3), generator=g, device=device, dtype=torch.uint8)
    return ((u8.float() * np.float32(1.0 / 255.0) - 0.5) / 0.5).to(torch.bfloat16)
