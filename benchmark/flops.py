"""Operations and bytes of the composite's work, counted from shapes, and
the card's peaks: the yardstick of the ``mfu.*`` and ``roofline.*``
metrics (the arithmetic of ``chip_smoke.py::bound`` and its K3 / K4 rows).

A product of m x k by k x n is 2 m k n operations.  ``Ops`` keeps them by
the precision of the product: ``int8`` for the linears of a W8A8
configuration, ``bf16`` for everything else, attention included.  MoE
layers count the experts a token is routed to (``num_experts_per_tok``),
not the dense route's all; a train step counts every forward once (no
remat recompute), dx through the frozen layers, and dx + dW of the
trained modules.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit)
PEAK = {"bf16": 989e12, "int8": 1979e12}
PEAK_BYTES_S = 3.35e12


@dataclass
class Ops:
    bf16: float = 0.0
    int8: float = 0.0

    def __add__(self, o: "Ops") -> "Ops":
        return Ops(self.bf16 + o.bf16, self.int8 + o.int8)

    def __mul__(self, k: float) -> "Ops":
        return Ops(self.bf16 * k, self.int8 * k)

    __rmul__ = __mul__

    def seconds_at_peak(self) -> float:
        """The least time the card could take: each precision at its peak."""
        return self.bf16 / PEAK["bf16"] + self.int8 / PEAK["int8"]


def bound_s(ops: float, nbytes: float, peak: float = PEAK["bf16"]) -> float:
    """max(operations / peak, bytes / memory rate), seconds."""
    return max(ops / peak, nbytes / PEAK_BYTES_S)


def _lin(c: dict, ops: float) -> Ops:
    quant = c.get("quantized") == "w8a8"
    return Ops(int8=ops) if quant else Ops(bf16=ops)


def decoder_token_ops(c: dict) -> Ops:
    """One position through every decoder layer's projections (attention
    scores apart) and nothing else."""
    H, I, D = c["hidden_size"], c["intermediate_size"], c["head_dim"]
    Hq, Hk = c["num_attention_heads"], c["num_key_value_heads"]
    attn = 2 * H * (Hq + 2 * Hk) * D + 2 * Hq * D * H
    E = c.get("num_local_experts", 0)
    ffn = 2 * H * E + c["num_experts_per_tok"] * 3 * 2 * H * I if E else 3 * 2 * H * I
    return _lin(c, c["num_hidden_layers"] * (attn + ffn))


def head_ops(c: dict) -> Ops:
    return _lin(c, 2 * c["hidden_size"] * (c["vocab_size"] + c.get("num_extra_tokens", 0)))


def attention_ops(c: dict, pairs: float) -> Ops:
    """Scores and the weighted sum over ``pairs`` (query, key) pairs in
    every layer: 4 D per pair and query head."""
    return Ops(bf16=4 * c["head_dim"] * c["num_attention_heads"] * c["num_hidden_layers"] * pairs)


def causal_pairs(n: int) -> int:
    return n * (n + 1) // 2


def tower_ops(c: dict) -> Ops:
    """One image through the tower's layers that run."""
    v = c["vision"]
    C, Iv, P = v["hidden_size"], v["intermediate_size"], v["patch_size"]
    T = (v["image_size"] // P) ** 2
    layers = v["num_hidden_layers"] + 1 + v["select_layer"]
    return (Ops(bf16=2 * 3 * P * P * C * T + layers * 4 * T * T * C)
            + _lin(c, layers * 2 * T * (4 * C * C + 2 * C * Iv)))


def trained_ops(c: dict, regions: int) -> Ops:
    """One image through the modules the align step trains: the
    refinement's deconvs, the projector, the region projectors."""
    v, H = c["vision"], c["hidden_size"]
    C = v["hidden_size"]
    refine, px = 0.0, (v["image_size"] // v["patch_size"]) ** 2
    for _ in range(c["region"]["deconv_depth"]):
        refine += 2 * C * C * 4 * px
        px *= 4
    tokens = ((c["region"]["ada_pool_size"] + 1) // 2) ** 2
    return Ops(bf16=refine + 2 * tokens * (4 * C * H + H * H) + 2 * regions * 2 * C * H)


def image_ops(c: dict, regions: int) -> Ops:
    """One request's image and depth map through the tower, and the
    trained modules."""
    return tower_ops(c) * 2 + trained_ops(c, regions)


def train_step_ops(c: dict, sample_lengths, regions: int) -> Ops:
    """One align step over samples of these lengths (one image each): the
    forward, dx through the frozen decoder (1x its products, 2x its
    attention), the head's dx, and the trained modules' dx and dW (2x)."""
    live = sum(sample_lengths)
    pairs = sum(causal_pairs(n) for n in sample_lengths)
    n = len(sample_lengths)
    dec = decoder_token_ops(c) * live + head_ops(c) * live
    fwd = dec + attention_ops(c, pairs) + image_ops(c, regions) * n
    bwd = dec + attention_ops(c, pairs) * 2 + trained_ops(c, regions) * (2 * n)
    return fwd + bwd


def prefill_ops(c: dict, prompt_len: int, regions: int) -> Ops:
    """One request's admission: its image, its live prompt positions, the
    head at the last one."""
    return (image_ops(c, regions) + decoder_token_ops(c) * prompt_len
            + attention_ops(c, causal_pairs(prompt_len)) + head_ops(c))


def decode_ops(c: dict, keys: int) -> Ops:
    """One decode position attending ``keys`` cache positions."""
    return decoder_token_ops(c) + attention_ops(c, keys) + head_ops(c)


# ---- K4 (the align step's flash attention) and K3 (int8 decode attention) ---


def k4_bounds(c: dict, rows: int, seq: int, sample_lengths) -> dict:
    """Seconds per call at the card's peaks of K4's forward, dQ and dK/dV
    kernels on packed rows of ``seq`` positions holding these samples:
    causal same-sample pairs only, per-position tensors read at live
    positions only (``chip_smoke.py``'s K4 rows)."""
    D, Hq, Hk = c["head_dim"], c["num_attention_heads"], c["num_key_value_heads"]
    window = c.get("sliding_window") or 0
    pairs = 0
    for n in sample_lengths:
        w = min(window, n) if window else n
        pairs += w * (w + 1) // 2 + (n - w) * w
    live = sum(sample_lengths)
    BS = rows * seq
    per_pos_bwd = (2 * Hq + 2 * Hk) * D * 2 + 2 * Hq * 4  # q, k, v, dO (bf16); lse, delta (f32)
    return {
        "fwd": bound_s(4 * D * Hq * pairs, live * (Hq + 2 * Hk) * D * 2 + BS * 4 + BS * Hq * D * 2 + BS * Hq * 4),
        "dkv": bound_s(8 * D * Hq * pairs, live * per_pos_bwd + BS * 4 + 2 * BS * Hk * D * 2),
        "dq": bound_s(6 * D * Hq * pairs, live * per_pos_bwd + BS * 4 + BS * Hq * D * 2),
    }


def k3_bytes(c: dict, slots: int, keys: int) -> float:
    """Bytes one K3 launch needs: the queries and outputs of every slot, the
    lengths, and ``keys`` live cache positions' int8 K and V with their f32
    scales."""
    D, Hq, Hk = c["head_dim"], c["num_attention_heads"], c["num_key_value_heads"]
    return 2 * slots * Hq * D * 2 + slots * 4 + keys * Hk * (2 * D + 2 * 4)
