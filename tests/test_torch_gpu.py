"""The port's CUDA kernels on the card: each against its plain PyTorch
version in bf16 (K2 and K6 also against planted faults), gradients through K1, K2, K4 and K6, a tiny region-QA
``generate`` through K1-K3, a tiny align step through K1 and K4, a
narrow demo pipeline (Depth-Anything -> SAM-HQ -> region QA) through K5
and K6, and the quantized projections: K7 and K8 bit-equal to their plain
versions, K9 within the bf16 bound, and a tiny W8A8 ``generate`` through
K1-K3 and K7-K9.

Every test here is marked ``gpu`` and skips where there is no CUDA card
(the kernels are CUDA C++ for sm_90a and have no CPU mode).  The file
imports no jax, so it also runs where the JAX package's test conftest
cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import numpy as np
import pytest
import torch

from spatialrgpt_tpu_torch.config import (
    LlamaConfig,
    ProjectorConfig,
    RegionExtractorConfig,
    SiglipVisionConfig,
    SpatialRGPTConfig,
)
from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.models.vlm import VLMInputs
from spatialrgpt_tpu_torch.ops import decode_attention as K3
from spatialrgpt_tpu_torch.ops import flash_attention as K4
from spatialrgpt_tpu_torch.ops import flash_attention as K5
from spatialrgpt_tpu_torch.ops import int8_linear as K789
from spatialrgpt_tpu_torch.ops import layer_norm as K6
from spatialrgpt_tpu_torch.ops import prefill_attention as K2
from spatialrgpt_tpu_torch.ops import vit_attention as K1
from spatialrgpt_tpu_torch.ops._checks import GRAD_FLOOR, bf16_err_over_bound
from spatialrgpt_tpu_torch.serving.generate import generate
from spatialrgpt_tpu_torch.utils.weights import init_random, init_random_quantized

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are CUDA C++ for sm_90a and have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(rng, *shape, device):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(device, torch.bfloat16)


def _bf16_close(out, ref, floor=0.0):
    # the kernel rounds P to bf16 at other running maxima and sums in
    # another order: 4 bf16 ulps of each element plus of
    # its row's largest value (tests/test_torch_kernels.py shows that this
    # bound rejects a kernel that skips one key tile); gradients add
    # GRAD_FLOOR for the rows that cancel to 0
    ratio = bf16_err_over_bound(out, ref, floor)
    assert ratio <= 1.0, ratio


_VIT_CASES = [(S, None) for S in (1, 63, 64, 65, 127, 128, 129, 729, 4096)] + [
    (65, 1), (129, 100), (256, 200), (729, 700), (4096, 4000)]


@pytest.mark.parametrize("D", [64, 72, 80])
@pytest.mark.parametrize("S,valid_len", _VIT_CASES)
def test_vit_kernel_matches_plain(cuda, S, valid_len, D):
    """K1 on the Hopper main loop against its plain version: head dims 64
    (one swizzle atom), 72 (SigLIP) and 80 (both atoms full); S around the
    128-row tiles (a ragged last query and key tile, a single token,
    SigLIP's 729, SAM's 4096), and keys masked from valid_len < S on."""
    rng = np.random.default_rng(S * 100 + D)
    B, H = (1, 2) if S >= 4096 else (3, 4)
    q, k, v = (_rand(rng, B, S, H, D, device=cuda) for _ in range(3))
    before = K1.launches
    out = K1.vit_attention(q, k, v, valid_len=valid_len)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    _bf16_close(out, K1.vit_attention_plain(q, k, v, valid_len=valid_len))


@pytest.mark.parametrize("S,D", [(100, 72), (729, 72), (300, 64), (129, 80)])
def test_vit_kernel_reads_strided_heads(cuda, S, D):
    """q/k/v as views into a fused (B, S, 3, H, D) projection: the tensor
    maps read through strides, no copy."""
    qkv = _rand(np.random.default_rng(1), 2, S, 3, 4, D, device=cuda)
    q, k, v = qkv.unbind(2)
    assert not q.is_contiguous()
    _bf16_close(K1.vit_attention(q, k, v), K1.vit_attention_plain(q, k, v))


def test_vit_bound_separates_a_skipped_key_tile(cuda):
    """A K1 that skips one 128-key tile fails the bound that the sound
    kernel meets.  Attention does not depend on the order of the keys, so
    the kernel run on keys whose tile 2 was moved to the end, with
    valid_len cutting it off, is exactly a kernel that skips that tile."""
    rng = np.random.default_rng(4)
    B, S, H, D = 2, 729, 4, 72
    q, k, v = (_rand(rng, B, S, H, D, device=cuda) for _ in range(3))
    ref = K1.vit_attention_plain(q, k, v)
    tile = slice(256, 384)

    def moved(t):
        return torch.cat([t[:, : tile.start], t[:, tile.stop :], t[:, tile]], dim=1)

    assert bf16_err_over_bound(K1.vit_attention(q, moved(k), moved(v)), ref) <= 1.0
    assert bf16_err_over_bound(K1.vit_attention(q, moved(k), moved(v), valid_len=S - 128), ref) > 1.0


def _causal_segment_live(seg):
    """(B, S, S) bool: key j is live for query i iff both lie in one nonzero
    segment and j <= i (K2's rule without a window)."""
    i = torch.arange(seg.shape[1], device=seg.device)
    return (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0) & (i[:, None] >= i[None, :])


def _masked_attention(q, k, v, live):
    """The plain version's arithmetic (f32 scores, P rounded to bf16) over
    the (query, key) pairs that ``live`` allows; rows with none are zeros."""
    B, S, Hq, D = q.shape
    Hk = k.shape[2]
    s = torch.einsum("bqhgd,bkhd->bhgqk", q.reshape(B, S, Hk, Hq // Hk, D).float(), k.float()) * D**-0.5
    p = torch.softmax(s.masked_fill(~live[:, None, None], float("-inf")), dim=-1).nan_to_num(0.0)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(torch.bfloat16).float(), v.float())
    return out.reshape(B, S, Hq, D).to(torch.bfloat16)


@pytest.mark.parametrize("S", [1, 70, 129, 320, 1000])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4, 8])
def test_onepass_kernel_matches_plain(cuda, G, D, S):
    """K2 on the Hopper main loop against its plain version: G = Hq / Hk of
    1 (sheared-3b's MHA), 4 (llama3-8b's GQA) and 8, folded into the CTA's
    128 query rows; D 64 (TMA's zero fill pads it to 128) and 128; S from
    one token to 1000 (ragged last query and key tiles).  Rows: one
    segment, right padding, two packed segments, all padding.  Once with no
    window on q/k/v as strided views of one fused projection, once with a
    window of 37 on contiguous tensors."""
    rng = np.random.default_rng(G * 10000 + D * 10 + S)
    Hk = 2
    Hq = G * Hk
    q, k, v = _rand(rng, 4, S, Hq + 2 * Hk, D, device=cuda).split([Hq, Hk, Hk], dim=2)
    assert not q.is_contiguous()
    seg = torch.ones(4, S, dtype=torch.int32, device=cuda)
    seg[1, S // 2 + 1 :] = 0  # right padding
    seg[2, S // 3 :] = 2  # two packed segments
    seg[3] = 0  # all padding
    for (qq, kk, vv), window in (((q, k, v), None), ((q.contiguous(), k.contiguous(), v.contiguous()), 37)):
        before = K2.launches
        out = K2.onepass_attention(qq, kk, vv, seg, window=window)
        torch.cuda.synchronize()
        assert K2.launches == before + 1
        assert torch.all(out[seg == 0] == 0)
        _bf16_close(out, K2.onepass_attention_plain(qq, kk, vv, seg, window=window))


@pytest.mark.parametrize("fault", ["diagonal_tile", "segment_tiles"])
def test_onepass_bound_separates_a_skipped_key_tile(cuda, fault):
    """At the serving shape (S 320, Hq 32 over Hk 8, D 128) on rows of two
    packed segments and padding, a K2 that leaves out key tiles fails the
    bound that the sound kernel meets.  "diagonal_tile": every query loses
    the keys of its own 128-key tile (the plain arithmetic with those pairs
    masked).  "segment_tiles": the queries of segment 2 (positions 100-299)
    in the last tile lose the segment's keys in the two tiles before it;
    that output is the kernel's own, run with positions 100-255 given
    another segment id (only rows >= 256 are compared: their queries and
    live keys are the sound run's)."""
    rng = np.random.default_rng(11)
    B, S, Hq, Hk, D = 2, 320, 32, 8, 128
    q = _rand(rng, B, S, Hq, D, device=cuda)
    k, v = (_rand(rng, B, S, Hk, D, device=cuda) for _ in range(2))
    seg = torch.zeros(B, S, dtype=torch.int32, device=cuda)
    seg[:, :100] = 1
    seg[:, 100:300] = 2
    ref = K2.onepass_attention_plain(q, k, v, seg)
    out = K2.onepass_attention(q, k, v, seg)
    if fault == "diagonal_tile":
        tile = torch.arange(S, device=cuda) // 128
        fault_out = _masked_attention(q, k, v, _causal_segment_live(seg) & (tile[:, None] != tile[None, :]))
        rows = slice(None)
        assert bf16_err_over_bound(_masked_attention(q, k, v, _causal_segment_live(seg)), ref) <= 1.0
    else:
        cut = seg.clone()
        cut[:, 100:256] = 3
        fault_out = K2.onepass_attention(q, k, v, cut)
        rows = slice(256, S)
    assert bf16_err_over_bound(out[:, rows], ref[:, rows]) <= 1.0
    assert bf16_err_over_bound(fault_out[:, rows], ref[:, rows]) > 1.0


_DECODE_CASES = [
    (4, 352, 32, 8, 128),  # the serve cache: n_rep 4, a cluster of 2
    (3, 17, 4, 2, 8),  # D 8: 4-byte copies, one CTA
    (2, 1000, 8, 8, 64),  # n_rep 1, D 64, a cluster of 4
    (3, 352, 8, 8, 256),  # n_rep 1, D 256
    (3, 4096, 32, 4, 128),  # n_rep 8, the engine's long capacity, a cluster of 8
    (2, 4096, 8, 1, 64),  # n_rep 8, D 64
    (3, 2000, 16, 2, 256),  # n_rep 8, D 256: 250 positions a CTA, more than one slab of 240
    (2, 300, 6, 2, 12),  # n_rep 3, D 12
]


@pytest.mark.parametrize("B,C,Hq,Hk,D", _DECODE_CASES)
def test_decode_kernel_matches_plain(cuda, B, C, Hq, Hk, D):
    """K3, one launch of a cluster of K3.decode_cluster_size(C) CTAs per
    (row, kv head), against its plain version: n_rep 1-8, D 8-256 (4- and
    16-byte copies), C from 17 to 4096 (clusters of 1, 2, 4 and 8; a CTA
    share longer than one shared-memory slab), rows with lengths 0 (one
    live position) and C - 1 (all live)."""
    rng = np.random.default_rng(C + D)
    q = _rand(rng, B, Hq, D, device=cuda)
    kq = torch.tensor(rng.integers(-127, 128, (B, C, Hk * D)).astype(np.int8), device=cuda)
    vq = torch.tensor(rng.integers(-127, 128, (B, C, Hk * D)).astype(np.int8), device=cuda)
    ks = torch.tensor(rng.uniform(0.002, 0.03, (B, C, Hk)).astype(np.float32), device=cuda)
    vs = torch.tensor(rng.uniform(0.002, 0.03, (B, C, Hk)).astype(np.float32), device=cuda)
    lengths = torch.tensor(([0, C - 1] + list(rng.integers(0, C, B)))[:B], dtype=torch.int32, device=cuda)
    before = K3.launches
    out = K3.decode_attention_int8_flat(q, kq, ks, vq, vs, lengths, Hk)
    torch.cuda.synchronize()
    assert K3.launches == before + 1
    _bf16_close(out, K3.decode_attention_int8_flat_plain(q, kq, ks, vq, vs, lengths, Hk))


# the serve cache's shape; scores spread over a few units (k_scale 0.03:
# std ~2.2), v scales of 2^e (1 + 0.45 * 2^-7), which bf16 rounds down by
# 0.35%, so the rounding of P * v_scale moves the outputs (most in the row
# with one live position, where P = 1)
DECODE_ROUNDING_SHAPE = (4, 352, 32, 8, 128)
DECODE_ROUNDING_LENGTHS = (0, 3, 100, 351)
# kernel against plain version, relative L2 over the output: only f32
# summation order differs (the score dot products and the PV sums), which
# moves P by ~1e-7 and flips a bf16 rounding of P or of the output rarely;
# a change of where P is rounded moves each term by up to 2^-8
DECODE_ROUNDING_REL = 1e-3


def decode_rounding_case(rng, device):
    """(q, k_q, k_s, v_q, v_s, lengths, Hk) where rounding P * v_scale to
    bf16 changes K3's output."""
    B, C, Hq, Hk, D = DECODE_ROUNDING_SHAPE
    q = torch.tensor(rng.standard_normal((B, Hq, D)).astype(np.float32)).to(device, torch.bfloat16)
    kq, vq = (torch.tensor(rng.integers(-127, 128, (B, C, Hk * D)).astype(np.int8), device=device) for _ in range(2))
    ks = torch.tensor(rng.uniform(0.027, 0.033, (B, C, Hk)).astype(np.float32), device=device)
    vs = torch.tensor((2.0 ** rng.integers(0, 4, (B, C, Hk)) * (1 + 0.45 * 2**-7)).astype(np.float32), device=device)
    lengths = torch.tensor(DECODE_ROUNDING_LENGTHS, dtype=torch.int32, device=device)
    return q, kq, ks, vq, vs, lengths, Hk


def decode_f32_p(q, k_q, k_s, v_q, v_s, lengths, n_heads):
    """K3's plain version with P * v_scale kept in f32: the rounding of the
    kernel before it was made one launch."""
    B, Hq, D = q.shape
    C, Hk = k_q.shape[1], n_heads
    kf = k_q.reshape(B, C, Hk, D).float()
    s = torch.einsum("bhgd,bchd->bhgc", q.reshape(B, Hk, Hq // Hk, D).float(), kf)
    s = s * (k_s.float().permute(0, 2, 1)[:, :, None, :] * D**-0.5)
    live = torch.arange(C, device=q.device)[None, :] <= lengths[:, None]
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, K3.NEG_INF))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    pv = p * v_s.float().permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bhgc,bchd->bhgd", pv, v_q.reshape(B, C, Hk, D).float()) / p.sum(dim=-1, keepdim=True)
    return o.reshape(B, Hq, D).to(q.dtype)


def test_decode_kernel_rounds_p_as_the_reference(cuda):
    """K3 rounds P * v_scale to bf16 relative to the row's max, as the
    Pallas kernel (decode_attention.py:124) and the plain version do: on
    inputs where that rounding shows, the kernel is within a relative L2 of
    1e-3 of the plain version, and an f32 P is not."""
    args = decode_rounding_case(np.random.default_rng(21), cuda)
    ref = K3.decode_attention_int8_flat_plain(*args)
    out = K3.decode_attention_int8_flat(*args)
    torch.cuda.synchronize()
    rel = ((out.float() - ref.float()).norm() / ref.float().norm()).item()
    rel_f32 = ((decode_f32_p(*args).float() - ref.float()).norm() / ref.float().norm()).item()
    assert rel <= DECODE_ROUNDING_REL < rel_f32, (rel, rel_f32)
    _bf16_close(out, ref)


def _packed(B, S, device):
    """Row 0: three packed segments and a padded tail; other rows: one
    segment, right-padded."""
    seg = torch.zeros(B, S, dtype=torch.int32, device=device)
    seg[0, : S // 3] = 1
    seg[0, S // 3 : 2 * S // 3] = 2
    seg[0, 2 * S // 3 : S - 50] = 3
    seg[1:, : S - 70] = 1
    return seg


def _check_flash_kernels(q, k, v, dout, seg, window):
    """K4's three kernels once each on these inputs against their plain
    versions (out and dK/dV/dQ within the bf16 bound, lse within 1e-4 on
    the rows with a live key and NEG_INF on the others, zeros on padding),
    then autograd through ``flash_attention``: the same kernels on the same
    inputs (padding rows of dO add nothing), so bit-equal gradients."""
    before = dict(K4.launches)
    out, lse = K4.flash_attention_fwd(q, k, v, seg, window)
    delta = K4.attention_delta(out, dout)
    dk, dv = K4.flash_attention_bwd_dkv(q, k, v, seg, lse, delta, dout, window)
    dq = K4.flash_attention_bwd_dq(q, k, v, seg, lse, delta, dout, window)
    torch.cuda.synchronize()
    assert {n: K4.launches[n] - before[n] for n in before} == dict.fromkeys(before, 1)
    ref, ref_lse = K4.flash_attention_fwd_plain(q, k, v, seg, window)
    _bf16_close(out, ref)
    live = lse > K4.NEG_INF / 2
    assert torch.equal(live, ref_lse > K4.NEG_INF / 2)
    torch.testing.assert_close(lse[live], ref_lse[live], rtol=0, atol=1e-4)
    assert torch.all(lse[~live] == K4.NEG_INF)
    rdk, rdv = K4.flash_attention_bwd_dkv_plain(q, k, v, seg, lse, delta, dout, window)
    rdq = K4.flash_attention_bwd_dq_plain(q, k, v, seg, lse, delta, dout, window)
    for got, want in ((dk, rdk), (dv, rdv), (dq, rdq)):
        _bf16_close(got, want, GRAD_FLOOR)
    pad = seg == 0
    assert torch.all(out[pad] == 0) and torch.all(dq[pad] == 0) and torch.all(dk[pad] == 0) and torch.all(dv[pad] == 0)
    ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    K4.flash_attention(*ins, seg, window=window).backward(dout)
    for t, want in zip(ins, (dq, dk, dv)):
        assert torch.equal(t.grad, want)
    return lse


@pytest.mark.parametrize(
    "B,S,Hq,Hk,D,window",
    [(2, 1024, 8, 2, 128, None), (3, 300, 4, 4, 128, None), (2, 257, 8, 1, 128, None), (2, 1024, 8, 2, 128, 200),
     (3, 300, 8, 2, 64, None), (3, 257, 8, 1, 64, 200), (2, 1000, 8, 2, 128, 50), (3, 700, 8, 1, 128, 200),
     (2, 300, 16, 2, 64, 50), (2, 129, 4, 4, 128, None)],
)
def test_flash_kernels_match_plain(cuda, B, S, Hq, Hk, D, window):
    """K4's forward (out and lse), dK/dV and dQ kernels against their plain
    versions in bf16: GQA 4:1, MHA and 8:1, packed segments, padding, S
    not a multiple of 64 or of dK/dV's 128 keys a CTA, sliding windows of
    50 and 200 (they cut inside the segments), D 64 (TMA's zero fill pads
    the tiles to 128), and with B 3 a row of padding only (no live key:
    lse NEG_INF, zeros in out, dq, dk and dv)."""
    rng = np.random.default_rng(5)
    q, dout = _rand(rng, B, S, Hq, D, device=cuda), _rand(rng, B, S, Hq, D, device=cuda)
    k, v = (_rand(rng, B, S, Hk, D, device=cuda) for _ in range(2))
    seg = _packed(B, S, cuda)
    if B > 2:
        seg[2] = 0
    lse = _check_flash_kernels(q, k, v, dout, seg, window)
    if B > 2:
        assert torch.all(lse[2] == K4.NEG_INF)


_SEGMENT_LAYOUTS = {
    # a segment that comes back after another (ids 1, 2, 1), padding between
    # segments, a segment id that is not the row's largest after a larger one
    "returning": ([(1, 150), (2, 100), (1, 200), (0, 50), (3, 100), (2, 100)], [(4, 64), (0, 128), (4, 300), (1, 208)]),
    # a 128-key tile of padding only (dK/dV's CTA with no live key), and
    # a tail tile of padding
    "padding_tile": ([(1, 128), (0, 128), (2, 200), (3, 244)], [(1, 300), (0, 212), (2, 188)]),
    # segments that start inside a tile of 64 and of 128
    "mid_tile": ([(0, 37), (5, 300), (6, 363)], [(1, 70), (2, 130), (3, 171), (0, 329)]),
}


@pytest.mark.parametrize(
    "layout,window,G,D",
    [("returning", None, 4, 128), ("returning", 50, 4, 128), ("padding_tile", 200, 1, 64),
     ("padding_tile", None, 8, 128), ("mid_tile", 50, 8, 128), ("mid_tile", 200, 4, 64)],
)
def test_flash_kernels_take_any_segment_layout(cuda, layout, window, G, D):
    """The forward and dQ list only the key tiles that hold a key of their
    queries' segment ids, dK/dV only the query tiles that hold a query of
    its keys' ids; the rule holds for any id layout, not only for packed
    samples (``_SEGMENT_LAYOUTS``), with G 1, 4 and 8, D 64 and 128 and
    windows of 50 and 200."""
    rng = np.random.default_rng(7)
    B, S, Hk = 2, 700, 2
    Hq = G * Hk
    q, dout = _rand(rng, B, S, Hq, D, device=cuda), _rand(rng, B, S, Hq, D, device=cuda)
    k, v = (_rand(rng, B, S, Hk, D, device=cuda) for _ in range(2))
    seg = torch.zeros(B, S, dtype=torch.int32, device=cuda)
    for b, runs in enumerate(_SEGMENT_LAYOUTS[layout]):
        assert sum(n for _, n in runs) == S
        start = 0
        for sid, n in runs:
            seg[b, start : start + n] = sid
            start += n
    _check_flash_kernels(q, k, v, dout, seg, window)


def test_kernel_gradients_match_plain(cuda):
    """The CUDA routes of K1 and K2 carry gradients to q, k and v, equal to
    the plain path's within the per-element bound (their backward
    recomputes the plain version)."""
    rng = np.random.default_rng(6)
    S = 200
    seg = _packed(2, S, cuda)
    cases = [
        (K1.vit_attention, K1.vit_attention_plain, (2, 100, 4, 72), (2, 100, 4, 72), ()),
        (K2.onepass_attention, K2.onepass_attention_plain, (2, S, 8, 128), (2, S, 2, 128), (seg,)),
    ]

    for fast, plain, qshape, kshape, extra in cases:
        q = _rand(rng, *qshape, device=cuda)
        k, v = (_rand(rng, *kshape, device=cuda) for _ in range(2))
        g = _rand(rng, *qshape, device=cuda)
        grads = []
        for fn in (fast, plain):
            ins = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            fn(*ins, *extra).backward(g)
            grads.append([t.grad for t in ins])
        for got, want in zip(*grads):
            assert got is not None
            _bf16_close(got, want, GRAD_FLOOR)


def test_tiny_generate_runs_the_three_kernels(cuda):
    """A tiny region-QA batch on the card: the kernel path launches K1 once
    per tower layer, K2 once per decoder layer and K3 once per decoder
    layer and decode step, and its first-token logits agree with the plain
    path's."""
    cfg = SpatialRGPTConfig(
        llm=LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, eos_token_id=63),
        vision=SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                                  num_attention_heads=2, image_size=56, patch_size=14),
        projector=ProjectorConfig(mm_hidden_size=32, hidden_size=64),
        region=RegionExtractorConfig(mm_hidden_size=32, hidden_size=64, ada_pool_size=4),
        mask_token_id=60, depth_token_id=61,
    )
    sb = expand_rows(
        [np.array([5, IMAGE_TOKEN_INDEX, 60, 61, 8], np.int64), np.array([IMAGE_TOKEN_INDEX, 7], np.int64)],
        None, max_len=64, tokens_per_image=4, mask_token_id=60, depth_token_id=61, regions_per_image=2, pad_to=12,
    )
    rng = np.random.default_rng(4)
    inputs = VLMInputs.from_spliced(
        sb, rng.standard_normal((2, 56, 56, 3)), rng.standard_normal((2, 56, 56, 3)),
        (rng.random((2, 2, 56, 56)) > 0.5).astype(np.float32), np.ones((2, 2), bool),
        device=cuda, dtype=torch.bfloat16,
    )
    plens = torch.as_tensor(sb.segment_ids.sum(axis=1), device=cuda)
    model = init_random(cfg, cuda, torch.bfloat16, seed=0)
    for m in (K1, K2, K3):
        m.launches = 0
    fast = generate(model, cfg, inputs, plens, max_new_tokens=5, eos_token_id=-1, attn_impl="onepass")
    assert (K1.launches, K2.launches, K3.launches) == (2, 2, 2 * 4)
    plain = generate(model, cfg, inputs, plens, max_new_tokens=5, eos_token_id=-1, attn_impl="xla")
    assert (K1.launches, K2.launches, K3.launches) == (2, 2, 2 * 4)
    assert fast.tokens.shape == (2, 5) and ((fast.tokens >= 0) & (fast.tokens < 64)).all()
    rel = (fast.first_logits - plain.first_logits).norm() / plain.first_logits.norm()
    assert float(rel) < 0.05


def test_tiny_align_step_runs_k1_and_k4(cuda):
    """A tiny align step (frozen decoder and tower, remat, chunked CE) on
    the card: K1 once per tower layer, K4's forward twice per decoder layer
    (forward and the remat recompute), each backward kernel once per layer;
    loss and the projector's gradient agree with the plain path's."""
    from spatialrgpt_tpu_torch.models import vlm
    from spatialrgpt_tpu_torch.train.optimizer import OptimizerConfig, build_optimizer

    cfg = SpatialRGPTConfig(
        llm=LlamaConfig(vocab_size=64, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2),
        vision=SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                                  num_attention_heads=2, image_size=56, patch_size=14),
        projector=ProjectorConfig(mm_hidden_size=32, hidden_size=256),
        region=RegionExtractorConfig(mm_hidden_size=32, hidden_size=256, ada_pool_size=4),
        mask_token_id=60, depth_token_id=61,
    )
    ids = [np.array([5, IMAGE_TOKEN_INDEX, 60, 61] + list(range(10, 60)), np.int64)] * 2
    sb = expand_rows(ids, ids, max_len=128, tokens_per_image=4, mask_token_id=60, depth_token_id=61,
                     regions_per_image=2, pad_to=128)
    rng = np.random.default_rng(7)
    inputs = VLMInputs.from_spliced(
        sb, rng.standard_normal((2, 56, 56, 3)), rng.standard_normal((2, 56, 56, 3)),
        (rng.random((2, 2, 56, 56)) > 0.5).astype(np.float32), np.ones((2, 2), bool),
        device=cuda, dtype=torch.bfloat16,
    )
    model = init_random(cfg, cuda, torch.bfloat16, seed=0)
    build_optimizer(model, OptimizerConfig(tune_language_model=False))
    results = []
    for impl in ("pallas", "xla"):
        K1.launches = 0
        K4.launches = dict.fromkeys(K4.launches, 0)
        model.zero_grad(set_to_none=True)
        loss, _ = vlm.loss_fn(model, cfg, inputs, attn_impl=impl, remat=True, ce_chunk=64)
        loss.backward()
        torch.cuda.synchronize()
        grad = torch.cat([p.grad.flatten().float() for p in model.mm_projector.parameters()])
        results.append((float(loss.detach()), grad, K1.launches, dict(K4.launches)))
    (loss, grad, k1, k4), (ploss, pgrad, pk1, pk4) = results
    assert k1 == 2 and k4 == {"flash_attention_fwd": 4, "flash_attention_bwd_dkv": 2, "flash_attention_bwd_dq": 2}
    assert pk1 == 0 and set(pk4.values()) == {0}
    assert abs(loss - ploss) <= 0.01 * abs(ploss)
    assert float((grad - pgrad).norm() / pgrad.norm()) < 0.05


@pytest.mark.parametrize("gh,gw,D", [(32, 48, 80), (32, 48, 64), (64, 64, 80), (64, 64, 64), (10, 13, 64),
                                     (13, 64, 72)])
def test_grid_bias_kernel_matches_plain(cuda, gh, gw, D):
    """K5 against its plain version: SAM vit_h's grid and head dim (64 x 64,
    D 80), vit_b's D 64 (TMA's zero fill pads it to 80), a grid row that is
    not a divisor of the 128-key tile (gw 48: tiles straddle rows), S = 130
    and 832, not multiples of 128; q/k/v are views into a fused (B, S, 3,
    H, D) projection, as SAM's attention passes them."""
    rng = np.random.default_rng(8)
    B, H, S = 2, 3, gh * gw
    q, k, v = _rand(rng, B, S, 3, H, D, device=cuda).unbind(2)
    rel_h = torch.tensor(rng.standard_normal((B, H, S, gh)).astype(np.float32), device=cuda)
    rel_w = torch.tensor(rng.standard_normal((B, H, S, gw)).astype(np.float32), device=cuda)
    before = K5.grid_bias_launches
    out = K5.grid_bias_attention(q, k, v, rel_h, rel_w, gw)
    torch.cuda.synchronize()
    assert K5.grid_bias_launches == before + 1
    _bf16_close(out, K5.grid_bias_attention_plain(q, k, v, rel_h, rel_w, gw))


def test_grid_bias_bound_separates_a_skipped_key_tile(cuda):
    """At vit_h's grid (gw 64) a grid row is half of one 128-key tile, so the
    kernel run with that row's rel_h at -inf is a kernel that skips those
    64 keys: against the plain version on the true bias it exceeds the
    bound that the sound kernel meets."""
    rng = np.random.default_rng(9)
    B, H, D, gh, gw = 1, 2, 80, 64, 64
    S = gh * gw
    q, k, v = (_rand(rng, B, S, H, D, device=cuda) for _ in range(3))
    rel_h = torch.tensor(rng.standard_normal((B, H, S, gh)).astype(np.float32), device=cuda)
    rel_w = torch.tensor(rng.standard_normal((B, H, S, gw)).astype(np.float32), device=cuda)
    ref = K5.grid_bias_attention_plain(q, k, v, rel_h, rel_w, gw)
    skipped = rel_h.clone()
    skipped[..., 17] = -torch.inf
    assert bf16_err_over_bound(K5.grid_bias_attention(q, k, v, rel_h, rel_w, gw), ref) <= 1.0
    assert bf16_err_over_bound(K5.grid_bias_attention(q, k, v, skipped, rel_w, gw), ref) > 1.0


def test_grid_bias_wrapper_raises_past_its_grid(cuda):
    """K5 keeps each CTA's rel_h and rel_w rows in shared memory, at most 64
    per side: a 65-wide grid raises on the card, before any launch."""
    rng = np.random.default_rng(10)
    B, H, D, gh, gw = 1, 2, 64, 2, 65
    S = gh * gw
    q, k, v = (_rand(rng, B, S, H, D, device=cuda) for _ in range(3))
    rel_h = torch.zeros(B, H, S, gh, device=cuda)
    rel_w = torch.zeros(B, H, S, gw, device=cuda)
    before = K5.grid_bias_launches
    with pytest.raises(ValueError, match="at most 64"):
        K5.grid_bias_attention(q, k, v, rel_h, rel_w, gw)
    assert K5.grid_bias_launches == before


def layer_norm_rows(rng, kind: str, rows: int, C: int) -> np.ndarray:
    """f32 rows for K6's tests, exact in bf16.  "normal": N(1, 3^2).
    "large_mean": 4096 with 2% of the entries one bf16 ulp off (4080 or
    4128): E[x^2] - mean^2 cancels ~20 of f32's 24 bits.  "near_constant":
    a value in [0.5, 2) per row with 1% of the entries one ulp above it,
    and every 8th row constant: the variance is at most ~eps (1e-6) and 0
    in the constant rows, so eps decides the result."""
    if kind == "normal":
        return (rng.standard_normal((rows, C)) * 3 + 1).astype(np.float32)
    r = rng.random((rows, C))
    if kind == "large_mean":
        x = np.full((rows, C), 4096.0)
        x[r < 0.01] = 4080.0
        x[(r >= 0.01) & (r < 0.02)] = 4128.0
        return x.astype(np.float32)
    base = torch.tensor(rng.uniform(0.5, 2.0, (rows, 1)).astype(np.float32)).to(torch.bfloat16)
    up = (base.float() * (1 + 2.0**-7)).to(torch.bfloat16)  # one ulp above
    x = torch.where(torch.tensor(r < 0.01), up, base).float()
    x[::8] = base[::8].float()
    return x.numpy()


_LN_CASES = [(4099, 1280, 0, "normal"), (37, 200, 0, "normal"), (5, 77, 0, "normal"), (3, 4100, 0, "normal"),
             (70, 256, 3, "normal"), (4099, 1280, 0, "large_mean"), (4096, 1024, 0, "near_constant")]


@pytest.mark.parametrize("weight_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,C,offset,kind", _LN_CASES)
def test_layer_norm_kernel_matches_plain(cuda, rows, C, offset, kind, weight_dtype):
    """K6 against its plain version: a ragged row count at SAM's width, a C
    that is a multiple of 8 but not of 128, a C that is not a multiple of 8
    (one element per lane), C > 2048 (the row read once per pass) and a row
    start that is not 16-byte aligned (the scalar route); weights in bf16,
    as the models hold them, and in f32.  Two kinds of rows that the other
    checks cannot tell apart from a faulty kernel: "large_mean" rows, where
    a kernel that computes the variance as E[x^2] - mean^2 fails the bound,
    and "near_constant" rows, where one that drops eps fails it; the case
    asserts that both faults, computed on the card, do.  Each call is one
    launch (no cast kernels), and gradients flow through the kernel route."""
    rng = np.random.default_rng(rows + C)
    flat = np.concatenate([np.zeros(offset, np.float32), layer_norm_rows(rng, kind, rows, C).reshape(-1)])
    x = torch.tensor(flat, device=cuda).to(torch.bfloat16)[offset:].view(rows, C)
    w, b = (torch.tensor(rng.standard_normal(C).astype(np.float32), device=cuda).to(weight_dtype) for _ in range(2))
    before = K6.launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = K6.fused_layer_norm(x, w, b, 1e-6)
        torch.cuda.synchronize()
    assert K6.launches == before + 1
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "layer_norm" in kernels[0], kernels
    ref = K6.fused_layer_norm_plain(x, w, b, 1e-6)
    _bf16_close(out, ref)
    if kind != "normal":
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        short_var = (xf * xf).mean(-1, keepdim=True) - mean * mean
        d = xf - mean
        faults = {"short_variance": d * torch.rsqrt(short_var + 1e-6), "no_eps": d * torch.rsqrt((d * d).mean(-1, keepdim=True))}
        fault = faults["short_variance" if kind == "large_mean" else "no_eps"]
        assert bf16_err_over_bound((fault * w.float() + b.float()).to(torch.bfloat16), ref) > 1.0
    g = _rand(rng, rows, C, device=cuda)
    grads = []
    for fn in (K6.fused_layer_norm, K6.fused_layer_norm_plain):
        ins = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        fn(*ins, 1e-6).backward(g)
        grads.append([t.grad for t in ins])
    for got, want in zip(*grads):
        assert got is not None and torch.equal(got, want)


def test_narrow_demo_pipeline_runs_k5_and_k6(cuda, monkeypatch):
    """The demo pipeline at full resolution (8 -> 4 photos of 768 x 1024,
    SAM at 1024 px, SigLIP at 384 px) but narrow and shallow models (width
    128, 1-4 layers), with ``SRGPT_FUSED_LN``'s switch on: K5 once per SAM
    global layer and chunk, K6 at every LayerNorm that passes the gate
    (Depth-Anything 2 x 4 layers + 4 final norms; per SAM chunk 2 x 2
    layers + 2 neck + the compress-ViT norm, the rest of the mask decoder
    runs in f32 as the reference's does; SigLIP 2 x 1 layer + the
    refinement norm: 12 + 2 x 7 + 3 = 29); outputs agree with the plain
    path's (K5's and K6's plain versions, the VLM's xla route)."""
    from spatialrgpt_tpu_torch.demo import pipeline
    from spatialrgpt_tpu_torch.models import depth_anything as tda
    from spatialrgpt_tpu_torch.models import sam as tsam
    from spatialrgpt_tpu_torch.ops import layers
    from spatialrgpt_tpu_torch.utils.weights import init_random_depth_anything, init_random_sam_hq

    cfg = SpatialRGPTConfig(
        llm=LlamaConfig(vocab_size=64, hidden_size=128, intermediate_size=256, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, eos_token_id=63),
        vision=SiglipVisionConfig(hidden_size=128, intermediate_size=256, num_hidden_layers=2, num_attention_heads=2),
        projector=ProjectorConfig(mm_hidden_size=128, hidden_size=128),
        region=RegionExtractorConfig(mm_hidden_size=128, hidden_size=128),
        mask_token_id=60, depth_token_id=61,
    )
    scfg = tsam.SamConfig(
        vision=tsam.SamVisionConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                                    output_channels=128, global_attn_indexes=(1,)),
        prompt_hidden_size=128, decoder_hidden_size=128, decoder_num_heads=4, decoder_mlp_dim=256,
    )
    dcfg = tda.DepthAnythingConfig(hidden_size=128, num_hidden_layers=4, num_attention_heads=2, intermediate_size=256,
                                   out_indices=(1, 2, 3, 4), neck_hidden_sizes=(32, 64, 128, 128),
                                   fusion_hidden_size=64, head_hidden_size=16)
    models = pipeline.DemoModels(
        depth=tda.DepthPredictor(init_random_depth_anything(dcfg, cuda, torch.bfloat16, seed=1), dcfg),
        sam=init_random_sam_hq(scfg, cuda, torch.bfloat16, seed=2), sam_cfg=scfg,
        vlm=init_random(cfg, cuda, torch.bfloat16, seed=3), vlm_cfg=cfg,
    )
    rng = np.random.default_rng(10)
    B, h, w = 4, 768, 1024
    images = torch.tensor(np.stack([pipeline.synth_photo(rng, h, w) for _ in range(B)]), device=cuda)
    boxes = torch.tensor(pipeline.demo_boxes(B, h, w), device=cuda)
    sb = pipeline.demo_prompts(cfg, rng, B)
    runs = {}
    for impl, fused in (("onepass", True), ("xla", False)):
        monkeypatch.setattr(layers, "FUSED_LN", fused)
        K5.grid_bias_launches, K6.launches = 0, 0
        out = pipeline.run_pipeline(models, images, boxes, sb, 4, attn_impl=impl, chunk=2, sync=torch.cuda.synchronize)
        runs[impl] = (out, (K5.grid_bias_launches, K6.launches), models.depth.depth(images))
    (fast, launches, depth), (plain, plain_launches, plain_depth) = runs["onepass"], runs["xla"]
    assert launches == (2, 29) and plain_launches == (0, 0)
    assert fast.colorized.shape == (B, h, w, 3) and fast.mask_logits.shape == (2 * B, 256, 256)

    def rel(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    assert float(plain_depth.float().std()) > 0 and rel(depth, plain_depth) < 0.05
    assert rel(fast.mask_logits, plain.mask_logits) < 0.05
    assert rel(fast.result.first_logits, plain.result.first_logits) < 0.05


# ---------------------------------------------------------------------------
# K7-K9: the quantized projections
# ---------------------------------------------------------------------------


def _quant_rows(rng, M, K, device):
    """bf16 rows of x: normal rows, a row of zeros (padding: ascale 1e-12,
    xq 0), a row whose max is 127 so that ascale is 1 and its .5 values are
    ties (round half to even), and rows of a large and a tiny scale."""
    x = rng.standard_normal((M, K)).astype(np.float32)
    if M >= 5:
        x[1] = 0.0
        x[2] = rng.integers(-126, 126, K) + 0.5
        x[2, 0] = 127.0
        x[3] *= 1e4
        x[4] *= 1e-6
    return torch.tensor(x).to(device, torch.bfloat16)


@pytest.mark.parametrize("M", [1, 37])
@pytest.mark.parametrize("K", [1152, 4304, 14336])
def test_act_quant_kernel_bit_equal(cuda, K, M):
    """K7 equals its plain version bit for bit: ties at .5, a zero row,
    SigLIP's 1152 and 4304 and Llama's 14,336."""
    x = _quant_rows(np.random.default_rng(K + M), M, K, cuda)
    before = K789.launches["act_quant_int8"]
    xq, s = K789.act_quant_int8(x)
    assert K789.launches["act_quant_int8"] == before + 1
    pq, ps = K789.act_quant_int8_plain(x)
    assert torch.equal(s, ps) and torch.equal(xq, pq)
    if M >= 5:
        assert float(s[2]) == 1.0 and float(s[1]) == np.float32(1e-12) and not xq[1].any()
        assert torch.equal(xq[2, 1:].float(), torch.round(x[2, 1:].float()))  # half to even


def _int8(rng, *shape, device):
    return torch.tensor(rng.integers(-127, 128, shape), dtype=torch.int8, device=device)


@pytest.mark.parametrize("bias", [None, torch.bfloat16, torch.float32])
@pytest.mark.parametrize("K", [64, 1152, 4304])
@pytest.mark.parametrize("M", [1, 8, 64, 2048, 20480])
def test_w8a8_kernel_bit_equal(cuda, M, K, bias):
    """K8 equals its plain version bit for bit over decode, tower and
    prefill row counts, a K tail (4304 % 64 = 16) and an odd N (ragged
    last column tile, scalar stores)."""
    rng = np.random.default_rng(M + K)
    N = 333
    xq, q = _int8(rng, M, K, device=cuda), _int8(rng, N, K, device=cuda)
    ascale = torch.tensor(rng.random(M) * 0.1 + 1e-3, dtype=torch.float32, device=cuda)
    scale = torch.tensor(rng.random(N) * 0.01 + 1e-4, dtype=torch.float32, device=cuda)
    b = None if bias is None else torch.tensor(rng.standard_normal(N), device=cuda).to(bias)
    before = K789.launches["w8a8_gemm"]
    out = K789.w8a8_gemm(xq, ascale, q, scale, b)
    assert K789.launches["w8a8_gemm"] == before + 1
    ref = K789.w8a8_gemm_plain(xq, ascale, q, scale, b)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("M", [1, 8, 64])
def test_w8_kernel_within_bound(cuda, M):
    """K9 at the decode down projection's K = 14,336 (odd N, bf16 bias)
    within the bf16 bound of its plain version: the f32 sums run in another
    order."""
    rng = np.random.default_rng(M)
    N, K = 1001, 14336
    x = _rand(rng, M, K, device=cuda)
    q = _int8(rng, N, K, device=cuda)
    scale = torch.full((N,), K**-0.5 * 3 / 127, dtype=torch.float32, device=cuda)
    b = _rand(rng, N, device=cuda)
    before = K789.launches["w8_gemm"]
    out = K789.w8_gemm(x, q, scale, b)
    assert K789.launches["w8_gemm"] == before + 1
    _bf16_close(out, K789.w8_gemm_plain(x, q, scale, b))


def test_quant_wrappers_raise_on_what_they_do_not_take(cuda):
    """K7-K9's wrappers on the card: a CPU tensor among CUDA ones, wrong
    dtypes, a K the kernels do not take, a misaligned row, a bad shape."""
    rng = np.random.default_rng(0)
    x = _rand(rng, 4, 64, device=cuda)
    xq, q = _int8(rng, 4, 64, device=cuda), _int8(rng, 32, 64, device=cuda)
    s4, s32 = torch.ones(4, device=cuda), torch.ones(32, device=cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        K789.w8a8_gemm(xq, s4, q.cpu(), s32)
    with pytest.raises(ValueError, match="CUDA device"):
        K789.w8_gemm(x, q, s32.cpu())
    with pytest.raises(TypeError):
        K789.act_quant_int8(x.float())
    with pytest.raises(TypeError):
        K789.w8a8_gemm(xq, s4, q.float(), s32)
    with pytest.raises(TypeError):
        K789.w8_gemm(x.half(), q, s32)
    with pytest.raises(TypeError):
        K789.w8a8_gemm(xq, s4, q, s32, out_dtype=torch.float32)
    with pytest.raises(ValueError, match="multiple of 8"):
        K789.act_quant_int8(x[:, :12].contiguous())
    with pytest.raises(ValueError, match="multiple of 16"):
        K789.w8_gemm(x[:, :24].contiguous(), q[:, :24].contiguous(), s32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        K789.w8a8_gemm(torch.empty(4 * 64 + 1, dtype=torch.int8, device=cuda)[1:].view(4, 64), s4, q, s32)
    with pytest.raises(ValueError, match="do not fit"):
        K789.w8_gemm(x, q[:, :48].contiguous(), s32)


def _tiny_quant_cfg():
    return SpatialRGPTConfig(
        llm=LlamaConfig(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2, eos_token_id=63),
        vision=SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                                  num_attention_heads=2, image_size=56, patch_size=14),
        projector=ProjectorConfig(mm_hidden_size=32, hidden_size=64),
        region=RegionExtractorConfig(mm_hidden_size=32, hidden_size=64, ada_pool_size=4),
        mask_token_id=60, depth_token_id=61,
    )


def test_tiny_w8a8_generate_runs_k7_to_k9(cuda, monkeypatch):
    """A tiny W8A8 (llm + vision) region-QA batch on the card: K7-K9
    launch where the reference's rule sends each projection (a contracting
    one below 2048 rows: K9; everything else W8A8: K7 once per group of
    siblings, K8 per projection), and the tokens equal those of the plain
    route (K7-K9's plain versions on the card, the same K1-K3)."""
    from spatialrgpt_tpu_torch.ops import layers

    cfg = _tiny_quant_cfg()
    sb = expand_rows(
        [np.array([5, IMAGE_TOKEN_INDEX, 60, 61, 8], np.int64), np.array([IMAGE_TOKEN_INDEX, 7], np.int64)],
        None, max_len=64, tokens_per_image=4, mask_token_id=60, depth_token_id=61, regions_per_image=2, pad_to=12,
    )
    rng = np.random.default_rng(4)
    inputs = VLMInputs.from_spliced(
        sb, rng.standard_normal((2, 56, 56, 3)), rng.standard_normal((2, 56, 56, 3)),
        (rng.random((2, 2, 56, 56)) > 0.5).astype(np.float32), np.ones((2, 2), bool),
        device=cuda, dtype=torch.bfloat16,
    )
    plens = torch.as_tensor(sb.segment_ids.sum(axis=1), device=cuda)
    model = init_random_quantized(cfg, cuda, w8a8=True, seed=0)
    steps = 4
    for name in K789.launches:
        K789.launches[name] = 0
    fast = generate(model, cfg, inputs, plens, max_new_tokens=steps + 1, eos_token_id=-1, attn_impl="onepass")
    # tower, 2 layers at 4 x 16 rows: qkv (one K7), out, fc1 W8A8, fc2
    # contracts (K9); each decoder layer at 24 prefill rows and at 2 decode
    # rows: qkv (one K7, q on K8, k/v contract: K9), o, gate/up (one K7),
    # down (K9); lm_head W8A8 at 2 rows
    tower = 2
    per_layer = {"act_quant_int8": 3, "w8a8_gemm": 4, "w8_gemm": 3}
    want = {name: tower * {"act_quant_int8": 3, "w8a8_gemm": 5, "w8_gemm": 1}[name]
            + (1 + steps) * (2 * per_layer[name] + (name != "w8_gemm")) for name in per_layer}
    assert K789.launches == want
    monkeypatch.setattr(layers, "QUANT_KERNELS", False)
    plain = generate(model, cfg, inputs, plens, max_new_tokens=steps + 1, eos_token_id=-1, attn_impl="onepass")
    assert K789.launches == want
    assert fast.tokens.shape == (2, steps + 1) and ((fast.tokens >= 0) & (fast.tokens < 64)).all()
    assert torch.equal(fast.tokens, plain.tokens)
    rel = (fast.first_logits - plain.first_logits).norm() / plain.first_logits.norm()
    assert float(rel) < 0.05
