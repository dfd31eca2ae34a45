"""The port's CUDA kernels on the card: each against its plain PyTorch
version in bf16 (K2 and K6 also against planted faults), gradients through K1, K2, K4 and K6, a tiny region-QA
``generate`` through K1-K3, a tiny align step through K1 and K4, a
narrow demo pipeline (Depth-Anything -> SAM-HQ -> region QA) through K5
and K6, the quantized projections: K7 and K8 bit-equal to their plain
versions, K9 within the bf16 bound, one profiler span of each K8 / K9
launch paired with its kernel, and a tiny W8A8 ``generate`` through
K1-K3 and K7-K9, and a tiny serving engine: its waves equal to lockstep
``generate`` on both caches, K3 against its plain version under slot
churn, a row driven past the cache inside a window, its decode window
replayed as a CUDA graph against the eager window, and the replay's K8 / K9
spans paired with their kernels; and the eval
runners (SpatialRGPT-Bench, region classification, VQA) on a tiny model;
and the synth pipeline's models (Swin, RAM, OWL-ViT, CameraNet) in bf16
against f32 on the CPU, with the SAM segmenter's K5 launches at B1; and
the decoder families: K2's D = 256 form, K3 at Gemma's cache, K8 / K9 at
Mixtral's router (N = 8) and Gemma's widths, tiny Mistral, Gemma and
Mixtral region-QA batches through the kernels; and K1's wide form (D 128,
InternViT-6B) beside CLIP's D 64, and narrow CLIP, InternViT, RADIO and MPT
models in bf16 against f32 on the CPU.

Every test here is marked ``gpu`` and skips where there is no CUDA card
(the kernels are CUDA C++ for sm_90a and have no CPU mode).  The file
imports no jax, so it also runs where the JAX package's test conftest
cannot load:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py -q
"""

import dataclasses
import types

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
from spatialrgpt_tpu_torch.serving import generate as generate_mod
from spatialrgpt_tpu_torch.serving.engine import ServingEngine
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


@pytest.mark.parametrize("D", [64, 72, 80, 96, 128])
@pytest.mark.parametrize("S,valid_len", _VIT_CASES)
def test_vit_kernel_matches_plain(cuda, S, valid_len, D):
    """K1 on the Hopper main loop against its plain version: head dims 64
    (one swizzle atom; CLIP), 72 (SigLIP) and 80 (both atoms full) on its
    narrow form, 96 and 128 (InternViT-6B) on its wide one; S around the
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


@pytest.mark.parametrize("S,D", [(100, 72), (729, 72), (300, 64), (129, 80), (1025, 128), (200, 104)])
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


@pytest.mark.parametrize("B,S,H,D", [(16, 577, 16, 64), (4, 1025, 25, 128)])
def test_vit_kernel_at_the_towers_shapes(cuda, B, S, H, D):
    """K1 at the new towers' shapes: CLIP ViT-L/14-336 (16 images, S 577,
    D 64, the narrow form) and InternViT-6B at 448 px (4 images, S 1025 =
    8 x 128 + 1, so the last key tile holds one live key; 25 heads, D 128,
    the wide form), one launch each."""
    rng = np.random.default_rng(S + D)
    q, k, v = (_rand(rng, B, S, H, D, device=cuda) for _ in range(3))
    before = K1.launches
    out = K1.vit_attention(q, k, v)
    torch.cuda.synchronize()
    assert K1.launches == before + 1
    _bf16_close(out, K1.vit_attention_plain(q, k, v))


def test_vit_wide_bound_separates_a_skipped_key_tile(cuda):
    """The wide form (D 128) meets the bound that a kernel skipping one
    128-key tile fails (the moved-tile construction of the narrow form's
    test), and the last tile's single live key at S 1025 counts: leaving
    it out fails the bound too."""
    rng = np.random.default_rng(5)
    B, S, H, D = 1, 1025, 5, 128
    q, k, v = (_rand(rng, B, S, H, D, device=cuda) for _ in range(3))
    ref = K1.vit_attention_plain(q, k, v)
    tile = slice(256, 384)

    def moved(t):
        return torch.cat([t[:, : tile.start], t[:, tile.stop :], t[:, tile]], dim=1)

    assert bf16_err_over_bound(K1.vit_attention(q, moved(k), moved(v)), ref) <= 1.0
    assert bf16_err_over_bound(K1.vit_attention(q, moved(k), moved(v), valid_len=S - 128), ref) > 1.0
    v_big = v.clone()
    v_big[:, -1] = 64.0  # the lone key of the last tile carries a value no other key has
    ref_big = K1.vit_attention_plain(q, k, v_big)
    assert bf16_err_over_bound(K1.vit_attention(q, k, v_big), ref_big) <= 1.0
    assert bf16_err_over_bound(K1.vit_attention(q, k, v_big, valid_len=S - 1), ref_big) > 1.0


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
    (8, 384, 16, 16, 256),  # Gemma-7B's serve cache (320 + 64): n_rep 1, D 256
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


_DECODE_INT4_CASES = [
    (64, 352, 32, 8, 128),  # generate(kv_bits=4) at the W8A8 serve's 64 rows: 64-byte head rows, 16-byte copies
    (3, 17, 4, 2, 8),  # D 8: 4-byte head rows, one CTA
    (2, 300, 6, 2, 24),  # n_rep 3, 12-byte head rows: 4-byte copies
    (3, 352, 8, 8, 256),  # n_rep 1, D 256
    (3, 4096, 32, 4, 128),  # n_rep 8, a cluster of 8
    (2, 4096, 16, 2, 256),  # 512 positions a CTA, more than one slab of 448 packed rows
]


@pytest.mark.parametrize("B,C,Hq,Hk,D", _DECODE_INT4_CASES)
def test_decode_int4_kernel_matches_plain(cuda, B, C, Hq, Hk, D):
    """K3's packed-int4 form (two nibbles a byte along D, low first) against
    its plain version (``unpack_kv4``, then the int8 form's arithmetic),
    over every nibble value: rows with lengths 0 and C - 1, one launch
    counted in ``launches_int4`` and none in the int8 form's count."""
    rng = np.random.default_rng(C + D + 1)
    q = _rand(rng, B, Hq, D, device=cuda)
    kq = torch.tensor(rng.integers(-128, 128, (B, C, Hk * D // 2)).astype(np.int8), device=cuda)
    vq = torch.tensor(rng.integers(-128, 128, (B, C, Hk * D // 2)).astype(np.int8), device=cuda)
    ks = torch.tensor(rng.uniform(0.02, 0.2, (B, C, Hk)).astype(np.float32), device=cuda)
    vs = torch.tensor(rng.uniform(0.02, 0.2, (B, C, Hk)).astype(np.float32), device=cuda)
    lengths = torch.tensor(([0, C - 1] + list(rng.integers(0, C, B)))[:B], dtype=torch.int32, device=cuda)
    before, before8 = K3.launches_int4, K3.launches
    out = K3.decode_attention_int4_flat(q, kq, ks, vq, vs, lengths, Hk)
    torch.cuda.synchronize()
    assert (K3.launches_int4, K3.launches) == (before + 1, before8)
    _bf16_close(out, K3.decode_attention_int4_flat_plain(q, kq, ks, vq, vs, lengths, Hk))


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
     (2, 300, 16, 2, 64, 50), (2, 129, 4, 4, 128, None),
     # the D = 256 forms (Gemma's head dim): MHA and G 2, windows, D 136
     # (TMA's zero fill pads the tiles to 256), a row of padding only
     (2, 1024, 4, 4, 256, None), (3, 300, 4, 2, 256, None), (2, 1000, 4, 2, 256, 50), (3, 700, 2, 1, 256, 200),
     (2, 257, 4, 4, 136, None), (2, 129, 4, 2, 256, None)],
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
     ("padding_tile", None, 8, 128), ("mid_tile", 50, 8, 128), ("mid_tile", 200, 4, 64),
     ("returning", 50, 2, 256), ("padding_tile", None, 1, 256), ("mid_tile", 200, 2, 256)],
)
def test_flash_kernels_take_any_segment_layout(cuda, layout, window, G, D):
    """The forward and dQ list only the key tiles that hold a key of their
    queries' segment ids, dK/dV only the query tiles that hold a query of
    its keys' ids; the rule holds for any id layout, not only for packed
    samples (``_SEGMENT_LAYOUTS``), with G 1, 2, 4 and 8, D 64, 128 and
    256 and windows of 50 and 200."""
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
    """The CUDA routes of K1 (both forms) and K2 carry gradients to q, k
    and v, equal to the plain path's within the per-element bound (their
    backward recomputes the plain version)."""
    rng = np.random.default_rng(6)
    S = 200
    seg = _packed(2, S, cuda)
    cases = [
        (K1.vit_attention, K1.vit_attention_plain, (2, 100, 4, 72), (2, 100, 4, 72), ()),
        (K1.vit_attention, K1.vit_attention_plain, (2, 150, 3, 128), (2, 150, 3, 128), ()),
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
    fast = generate(model, cfg, inputs, plens, max_new_tokens=5, eos_token_id=-1, attn_impl="onepass",
                    kv_quant=True)
    assert (K1.launches, K2.launches, K3.launches) == (2, 2, 2 * 4)
    plain = generate(model, cfg, inputs, plens, max_new_tokens=5, eos_token_id=-1, attn_impl="xla",
                     kv_quant=True)
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


_LN_CASES = [(4099, 1280, 0, "normal", 1e-6), (37, 200, 0, "normal", 1e-6), (5, 77, 0, "normal", 1e-6),
             (3, 4100, 0, "normal", 1e-6), (70, 256, 3, "normal", 1e-6), (4099, 1280, 0, "large_mean", 1e-6),
             (4096, 1024, 0, "near_constant", 1e-6), (4585, 768, 0, "normal", 1e-12)]


@pytest.mark.parametrize("weight_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows,C,offset,kind,eps", _LN_CASES)
def test_layer_norm_kernel_matches_plain(cuda, rows, C, offset, kind, eps, weight_dtype):
    """K6 against its plain version: a ragged row count at SAM's width, a C
    that is a multiple of 8 but not of 128, a C that is not a multiple of 8
    (one element per lane), C > 2048 (the row read once per pass) and a row
    start that is not 16-byte aligned (the scalar route), RAM's tagging
    head (4585 rows at C 768, eps 1e-12); weights in bf16,
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
    # a profiled warm-up call first: the first profiled calls of a process
    # can record no CUDA event at all while the tracer starts
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        K6.fused_layer_norm(x, w, b, eps)
        torch.cuda.synchronize()
    # and a profiled call that recorded no CUDA event at all (the tracer saw
    # nothing) is repeated, up to 3 times; a call that recorded any event is
    # the one counted
    for _ in range(1 + 3):
        before = K6.launches
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = K6.fused_layer_norm(x, w, b, eps)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if kernels:
            break
    assert K6.launches == before + 1
    assert len(kernels) == 1 and "layer_norm" in kernels[0], kernels
    ref = K6.fused_layer_norm_plain(x, w, b, eps)
    _bf16_close(out, ref)
    if kind != "normal":
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        short_var = (xf * xf).mean(-1, keepdim=True) - mean * mean
        d = xf - mean
        faults = {"short_variance": d * torch.rsqrt(short_var + eps), "no_eps": d * torch.rsqrt((d * d).mean(-1, keepdim=True))}
        fault = faults["short_variance" if kind == "large_mean" else "no_eps"]
        assert bf16_err_over_bound((fault * w.float() + b.float()).to(torch.bfloat16), ref) > 1.0
    g = _rand(rng, rows, C, device=cuda)
    grads = []
    for fn in (K6.fused_layer_norm, K6.fused_layer_norm_plain):
        ins = [t.detach().clone().requires_grad_() for t in (x, w, b)]
        fn(*ins, eps).backward(g)
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


# K7's and K10's rows: across the forms' boundaries (the narrow form's 8;
# K7's ring form past AQ_FEW_ROWS = 256 rows at 14,336, its narrower rows
# CTAs past AQ_MANY_ROWS = 4096), a decode step's 64, the prefill's 20,480;
# K from SigLIP's 1152 and 4304, Llama's 4096 and 14,336, a tp = 4 rank's
# 1024
_AQ_M = [1, 37, 64, 65, 263, 2048, 20480]
_AQ_K = [8, 1024, 1152, 4096, 4304, 14336]
_AQ_FORCED = ["picked", "loop", "ring", "rows"]


def _force_aq_form(monkeypatch, form):
    """``form``: "picked" leaves ``act_quant_form``'s choice; "loop",
    "ring" and "rows" take that form at every shape it holds (else the
    loop form)."""
    forced = {"loop": lambda K, dy: None, "ring": K789.act_quant_ring, "rows": lambda K, dy: K789.act_quant_rows(K)}
    if form != "picked":
        monkeypatch.setattr(K789, "act_quant_form",
                            lambda M, K, dy=False: forced[form](K, dy) or K789.AQ_LOOP_FORM)


@pytest.mark.parametrize("form", _AQ_FORCED)
@pytest.mark.parametrize("M,K", [(M, K) for K in _AQ_K for M in _AQ_M] + [(3, 131080), (263, 131080)])
def test_act_quant_kernel_bit_equal(cuda, monkeypatch, K, M, form):
    """K7 equals its plain version bit for bit in the form the wrapper
    picks and in each form forced: ties at .5, a zero row, huge and tiny
    rows, at every row count and width of ``_AQ_M`` x ``_AQ_K``, and rows
    too wide for the ring and rows forms (the loop form every way)."""
    _force_aq_form(monkeypatch, form)
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


# rows across K8's form boundary (DECODE_MAX_M = 128), the decode form's
# widths (8, 16, 32, 64 columns) and its 64-row tiles, the prefill's
# 2048-row W8A8 gate and its 20,480 rows; K from SigLIP's 1152 and 4304 (a
# k tail of 80 past 128-wide tiles) to Llama's 14,336 (a k split over a
# cluster at few channel tiles)
_QGEMM_M = [1, 8, 9, 63, 64, 65, 96, 129, 2048, 20480]
_QGEMM_K = [64, 1152, 4304, 14336]
_BIAS = [None, torch.bfloat16, torch.float32]


def _w8a8_case(rng, M, N, K, bias, device):
    xq, q = _int8(rng, M, K, device=device), _int8(rng, N, K, device=device)
    ascale = torch.tensor(rng.random(M) * 0.1 + 1e-3, dtype=torch.float32, device=device)
    scale = torch.tensor(rng.random(N) * 0.01 + 1e-4, dtype=torch.float32, device=device)
    b = None if bias is None else torch.tensor(rng.standard_normal(N), device=device).to(bias)
    return xq, ascale, q, scale, b


def _w8_case(rng, M, N, K, bias, device):
    x = _rand(rng, M, K, device=device)
    q = _int8(rng, N, K, device=device)
    scale = torch.full((N,), K**-0.5 * 3 / 127, dtype=torch.float32, device=device)
    b = None if bias is None else _rand(rng, N, device=device).to(bias)
    return x, q, scale, b


def _launched(name, fn, *args):
    before = K789.launches[name]
    out = fn(*args)
    assert K789.launches[name] == before + 1
    return out


@pytest.mark.parametrize("bias", _BIAS)
@pytest.mark.parametrize("K", _QGEMM_K)
@pytest.mark.parametrize("M", _QGEMM_M)
def test_w8a8_kernel_bit_equal(cuda, M, K, bias):
    """K8 equals its plain version bit for bit on both forms, over decode,
    tower and prefill row counts, K tails and an odd N (a ragged last
    channel tile, scalar stores)."""
    rng = np.random.default_rng(M + K)
    N = 333
    xq, ascale, q, scale, b = _w8a8_case(rng, M, N, K, bias, cuda)
    out = _launched("w8a8_gemm", K789.w8a8_gemm, xq, ascale, q, scale, b)
    ref = K789.w8a8_gemm_plain(xq, ascale, q, scale, b)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("M", [1, 64, 65, 96, 128, 129, 200])
@pytest.mark.parametrize("form", ["decode", "large"])
def test_w8a8_both_forms_around_the_boundary(cuda, monkeypatch, form, M):
    """K8's decode form (64-row tiles past 64 rows) and its large form, each
    forced on either side of ``DECODE_MAX_M``, equal the plain version (the
    form boundary's measurement runs both)."""
    monkeypatch.setattr(K789, "DECODE_MAX_M", 1 << 30 if form == "decode" else 0)
    rng = np.random.default_rng(M)
    xq, ascale, q, scale, b = _w8a8_case(rng, M, 1001, 4304, torch.float32, cuda)
    out = _launched("w8a8_gemm", K789.w8a8_gemm, xq, ascale, q, scale, b)
    assert torch.equal(out, K789.w8a8_gemm_plain(xq, ascale, q, scale, b))


@pytest.mark.parametrize("bias", _BIAS)
@pytest.mark.parametrize("K", _QGEMM_K)
@pytest.mark.parametrize("M", _QGEMM_M)
def test_w8_kernel_within_bound(cuda, M, K, bias):
    """K9 within the bf16 bound of its plain version (the f32 sums run in
    another order) over the same rows and K, an odd N and each bias kind."""
    rng = np.random.default_rng(M + K)
    N = 1001
    x, q, scale, b = _w8_case(rng, M, N, K, bias, cuda)
    out = _launched("w8_gemm", K789.w8_gemm, x, q, scale, b)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    _bf16_close(out, K789.w8_gemm_plain(x, q, scale, b))


@pytest.mark.parametrize("which", ["w8a8_gemm", "w8_gemm"])
def test_cluster_split_leaves_nothing_behind(cuda, which):
    """Decode shapes whose k is split over a cluster (k/v: 8 channel tiles;
    down: 32): launches back to back, with another input in between, give
    the same bits each time (no state between launches, a fixed order of
    K9's f32 sums)."""
    rng = np.random.default_rng(7)
    for M, N, K in ((64, 1024, 4096), (64, 4096, 14336), (8, 1024, 4096)):
        if which == "w8a8_gemm":
            args = _w8a8_case(rng, M, N, K, None, cuda)
            other = (torch.flip(args[0], (0,)),) + args[1:]
        else:
            args = _w8_case(rng, M, N, K, torch.bfloat16, cuda)
            other = (-args[0],) + args[1:]
        fn = getattr(K789, which)
        first = _launched(which, fn, *args)
        second = _launched(which, fn, *args)
        _launched(which, fn, *other)
        third = _launched(which, fn, *args)
        assert torch.equal(first, second) and torch.equal(first, third)
        if which == "w8a8_gemm":
            assert torch.equal(first, K789.w8a8_gemm_plain(*args))
        else:
            _bf16_close(first, K789.w8_gemm_plain(*args))


# K9's large form: ragged rows (a partial 256-row tile, more tiles than SMs
# at 16,384 + 7), an odd N (a ragged 128-channel tile, scalar stores) and N
# = 1024 (16-byte stores, the addend read ahead in registers), K tails past
# the 64-deep stage (1040, 4304) and the decode's widths
_W8_LARGE_M = [129, 300, 16384 + 7]
_W8_LARGE_K = [64, 1040, 4304]


@pytest.mark.parametrize("N", [1001, 1024])
@pytest.mark.parametrize("with_add", [False, True], ids=["no_add", "add"])
@pytest.mark.parametrize("bias", _BIAS)
@pytest.mark.parametrize("K", _W8_LARGE_K)
@pytest.mark.parametrize("M", _W8_LARGE_M)
def test_w8_large_form_within_bound(cuda, monkeypatch, M, K, bias, with_add, N):
    """K9's large form within the bf16 bound of its plain version, with and
    without the f32 addend, each bias kind."""
    monkeypatch.setattr(K789, "W8_DECODE_MAX_M", 0)
    rng = np.random.default_rng(M + K)
    x, q, scale, b = _w8_case(rng, M, N, K, bias, cuda)
    add = torch.tensor(rng.standard_normal((M, N)).astype(np.float32), device=cuda) if with_add else None
    out = _launched("w8_gemm", K789.w8_gemm, x, q, scale, b, add)
    assert out.dtype == torch.bfloat16 and out.shape == (M, N)
    _bf16_close(out, K789.w8_gemm_plain(x, q, scale, b, add))


@pytest.mark.parametrize("N", [100, 300, 1129, 8])
def test_w8_large_form_odd_channel_tiles(cuda, monkeypatch, N):
    """An odd count of 128-channel tiles (1, 3, 9), the last one ragged:
    the large form stores nothing past N (8: Mixtral's router, which QLoRA
    leaves on K9)."""
    monkeypatch.setattr(K789, "W8_DECODE_MAX_M", 0)
    rng = np.random.default_rng(N)
    x, q, scale, b = _w8_case(rng, 1000, N, 1040, torch.float32, cuda)
    out = _launched("w8_gemm", K789.w8_gemm, x, q, scale, b)
    assert out.shape == (1000, N)
    _bf16_close(out, K789.w8_gemm_plain(x, q, scale, b))


@pytest.mark.parametrize("M", [1, 63, 64, 65, 96, 128, 129, 192, 256, 257, 384, 385, 512, 513])
def test_w8_both_forms_around_the_boundary(cuda, monkeypatch, M):
    """K9's decode and large forms on the same inputs, each forced on either
    side of ``W8_DECODE_MAX_M``, both within the bf16 bound of the plain
    version (the form boundary's measurement runs both)."""
    rng = np.random.default_rng(M)
    x, q, scale, b = _w8_case(rng, M, 1024, 4096, torch.float32, cuda)
    add = torch.tensor(rng.standard_normal((M, 1024)).astype(np.float32), device=cuda)
    ref = K789.w8_gemm_plain(x, q, scale, b, add)
    for decode_max_m in (1 << 30, 0):
        monkeypatch.setattr(K789, "W8_DECODE_MAX_M", decode_max_m)
        _bf16_close(_launched("w8_gemm", K789.w8_gemm, x, q, scale, b, add), ref)


def test_w8_large_form_repeats_its_bits(cuda, monkeypatch):
    """The large form sums in one order (no k split): launches back to back,
    with another input in between, give the same bits."""
    monkeypatch.setattr(K789, "W8_DECODE_MAX_M", 0)
    rng = np.random.default_rng(5)
    args = _w8_case(rng, 4096 + 3, 4096, 4304, torch.bfloat16, cuda)
    first = _launched("w8_gemm", K789.w8_gemm, *args)
    second = _launched("w8_gemm", K789.w8_gemm, *args)
    _launched("w8_gemm", K789.w8_gemm, -args[0], *args[1:])
    third = _launched("w8_gemm", K789.w8_gemm, *args)
    assert torch.equal(first, second) and torch.equal(first, third)
    _bf16_close(first, K789.w8_gemm_plain(*args))


def test_w8a8_persistent_grid_walks_many_tiles(cuda):
    """The large form's persistent grid (one CTA per SM) walks more tiles
    than it has CTAs: SigLIP fc1's ragged N = 4304 and K = 1152 at the
    prefill's 20,480 rows, 160 x 17 tiles of 128 x 256."""
    M, N, K = 20480, 4304, 1152
    assert (M // 128) * -(-N // 256) > 2 * torch.cuda.get_device_properties(0).multi_processor_count
    rng = np.random.default_rng(11)
    xq, ascale, q, scale, b = _w8a8_case(rng, M, N, K, torch.bfloat16, cuda)
    out = _launched("w8a8_gemm", K789.w8a8_gemm, xq, ascale, q, scale, b)
    assert torch.equal(out, K789.w8a8_gemm_plain(xq, ascale, q, scale, b))


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


def test_qgemm_spans_pair_with_their_kernels(cuda, tmp_path):
    """Under ``torch.profiler`` every K8 / K9 launch (both forms, with and
    without the addend and a bias) writes one ``k8.*`` / ``k9.*`` host span
    of its launched shape, and the card runs one ``srgpt::qgemm::`` kernel a
    span, in the span's order and of the form and row tile it names; the
    benchmark's reader (``benchmark/spans.py``) pairs them and reads a
    roofline share."""
    import json
    import os
    import sys

    sys.path.append(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark"))
    import spans
    from timeline import SLICE, Timeline

    rng = np.random.default_rng(11)
    N, K = 1024, 4096
    calls = []
    for M in (64, 1024, 8):
        for bias in (None, torch.bfloat16):
            add = torch.tensor(rng.standard_normal((M, N)), dtype=torch.float32, device=cuda)
            xq, ascale, q, scale, b = _w8a8_case(rng, M, N, K, bias, cuda)
            calls.append((K789.w8a8_gemm, (xq, ascale, q, scale, b, torch.bfloat16, None)))
            calls.append((K789.w8a8_gemm, (xq, ascale, q, scale, b, torch.bfloat16, add)))
            x, q, scale, b = _w8_case(rng, M, N, K, bias, cuda)
            calls.append((K789.w8_gemm, (x, q, scale, b, None)))
            calls.append((K789.w8_gemm, (x, q, scale, b, add)))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):  # the first profiled calls of a process may record no CUDA event
        calls[0][0](*calls[0][1])
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SLICE):
            for fn, args in calls:
                fn(*args)
            torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    tl = Timeline(events)
    names = [n for _, _, n in spans.spans(tl, spans.GEMM.fullmatch)]
    kernels = [n for _, _, n in tl.kernels if spans.QGEMM in n]
    assert len(names) == len(kernels) == len(calls)
    assert names[:4] == [f"k8.decode:64x{N}x{K}", f"k8.decode:64x{N}x{K}+add", f"k9.decode:64x{N}x{K}",
                         f"k9.decode:64x{N}x{K}+add"]
    assert names[15] == f"k9.large:1024x{N}x{K}+add+bias"
    for name, kernel in zip(names, kernels):
        assert spans._gemm_kernel(spans.parse_gemm(name)) in kernel, (name, kernel)  # form and row tile
    assert spans.gemm_pairs([spans.parse_gemm(n) for n in names], kernels) == [(i, i) for i in range(len(calls))]
    assert spans.int8_gemm_roofline({"timeline": tl}) > 0


def _dy_rows(rng, M, N, device):
    """bf16 rows of dy (normal, a zero row: gscale 1e-30 and dyq 0, rows of a
    large and a tiny scale) and a weight scale per column."""
    dy = rng.standard_normal((M, N)).astype(np.float32)
    if M >= 4:
        dy[1] = 0.0
        dy[2] *= 1e4
        dy[3] *= 1e-6
    scale = torch.tensor(rng.random(N) * 0.01 + 1e-4, dtype=torch.float32, device=device)
    return torch.tensor(dy).to(device, torch.bfloat16), scale


# ragged and small shapes, an N that is not a multiple of 16 (8-byte copies
# of dyq: llama3-8b's lm_head contracts over 128,264), then the align step's:
# K11 for gate / up (14,336 -> 4096) and for down (4096 -> 14,336)
_DX_CASES = [(1, 16, 16), (1, 8, 16), (37, 1040, 4304), (200, 4112, 1024), (129, 1032, 64), (129, 128264, 64),
             (16384, 14336, 4096), (16384, 4096, 14336), (16384, 8, 4096)]  # the last: Mixtral's router dx


# K10's (rows, N): ``_AQ_M`` (the align step's 16,384 in place of the
# prefill's 20,480) x ``_AQ_K`` and 4104, whose rows lie 4112 bytes apart
# (K11's padded stride), beside the earlier ragged cases
_AQ_DY = sorted({(M if M != 20480 else 16384, N) for M in _AQ_M for N in _AQ_K + [4104]} | {(37, 1040), (200, 4104)})


@pytest.mark.parametrize("form", _AQ_FORCED)
@pytest.mark.parametrize("M,N", _AQ_DY)
def test_act_quant_dy_kernel_bit_equal(cuda, monkeypatch, M, N, form):
    """K10 equals its plain version bit for bit in the form the wrapper
    picks and in each form forced: a zero row, large and tiny rows, ragged
    and padded N, the align step's shapes and Mixtral's router (N = 8)
    over its rows."""
    _force_aq_form(monkeypatch, form)
    dy, scale = _dy_rows(np.random.default_rng(M + N), M, N, cuda)
    dyq, gs = _launched("act_quant_dy_int8", K789.act_quant_dy_int8, dy, scale)
    assert dyq.stride(0) == -(-N // 16) * 16
    pq, ps = K789.act_quant_dy_int8_plain(dy, scale)
    assert torch.equal(gs, ps) and torch.equal(dyq, pq)
    if M >= 4:
        assert float(gs[1]) == np.float32(1e-30) and not dyq[1].any()


@pytest.mark.parametrize("M,N,K", _DX_CASES)
def test_int8_dx_kernel_bit_equal(cuda, M, N, K):
    """K11 equals its plain version bit for bit: a ragged M, an N (the
    contracted axis, q's rows) that is not a multiple of the 64-deep tile
    or of 16, a K that is not a multiple of the 128-wide tile, and the
    align step's shapes."""
    rng = np.random.default_rng(M + N + K)
    dyq, q = _int8(rng, M, N, device=cuda), _int8(rng, N, K, device=cuda)
    gs = torch.tensor(rng.random(M) * 1e-4 + 1e-6, dtype=torch.float32, device=cuda)
    out = _launched("int8_dx_gemm", K789.int8_dx_gemm, dyq, q, gs)
    assert out.dtype == torch.bfloat16 and out.shape == (M, K)
    rows = 2048  # the plain version's f32 chunks, a slice of rows at a time
    ref = torch.cat([K789.int8_dx_gemm_plain(dyq[i:i + rows], q, gs[i:i + rows]) for i in range(0, M, rows)])
    assert torch.equal(out, ref)


@pytest.mark.parametrize("N,K", [(8, 16), (1032, 64), (14336, 4096), (4096, 14336), (128264, 4096)])
def test_int8_transpose_bit_equal(cuda, N, K):
    """K11's first launch alone: q^T as (K, N16) rows, equal to
    ``q.t().contiguous()`` on its first N columns, zeros past them."""
    rng = np.random.default_rng(N + K)
    q = _int8(rng, N, K, device=cuda)
    qt = K789.int8_transpose(q)
    assert qt.shape == (K, -(-N // 16) * 16)
    assert torch.equal(qt[:, :N], q.t().contiguous()) and not qt[:, N:].any()


@pytest.mark.parametrize("M,N,K", [(37, 1040, 4304), (129, 1032, 64), (300, 128264, 64), (2048, 4104, 1024)])
def test_int8_dx_kernel_on_k10_rows(cuda, M, N, K):
    """K11 on the rows that K10 writes (N rounded up to 16 apart where N % 16
    != 0, the lm_head's 128,264): bit-equal to the plain version on the same
    values, with no copy of dyq."""
    rng = np.random.default_rng(M + N)
    dy, scale = _dy_rows(rng, M, N, cuda)
    dyq, gs = _launched("act_quant_dy_int8", K789.act_quant_dy_int8, dy, scale)
    assert dyq.stride(0) % 16 == 0 and dyq.stride(0) >= N
    q = _int8(rng, N, K, device=cuda)
    out = _launched("int8_dx_gemm", K789.int8_dx_gemm, dyq, q, gs)
    assert torch.equal(out, K789.int8_dx_gemm_plain(dyq.contiguous(), q, gs))


def test_int8_dx_keeps_no_transposed_weight(cuda):
    """One lm_head-sized call (4096 rows x 128,264 -> 4096) allocates no more
    than a transposed copy of q and the output beyond its operands, and
    frees the copy before it returns."""
    g = torch.Generator(device=cuda).manual_seed(9)
    M, N, K = 4096, 128264, 4096
    dy = torch.randn(M, N, generator=g, device=cuda).to(torch.bfloat16)
    dyq, gs = K789.act_quant_dy_int8(dy, torch.rand(N, generator=g, device=cuda) * 1e-2 + 1e-4)
    del dy
    q = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8, device=cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    dx = K789.int8_dx_gemm(dyq, q, gs)
    torch.cuda.synchronize()
    transient = K * -(-N // 16) * 16
    assert torch.cuda.max_memory_allocated() - base <= transient + dx.numel() * dx.element_size() + 2**20
    assert torch.cuda.memory_allocated() - base == dx.numel() * dx.element_size()


def test_backward_kernel_wrappers_raise(cuda):
    """K10's and K11's wrappers on the card: a CPU tensor, wrong dtypes, an
    N or K the kernels do not take, shapes that do not fit."""
    rng = np.random.default_rng(0)
    dy, scale = _dy_rows(rng, 4, 64, cuda)
    dyq, q = _int8(rng, 4, 64, device=cuda), _int8(rng, 64, 32, device=cuda)
    gs = torch.ones(4, device=cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        K789.act_quant_dy_int8(dy, scale.cpu())
    with pytest.raises(TypeError):
        K789.act_quant_dy_int8(dy.float(), scale)
    with pytest.raises(ValueError, match="multiple of 8"):
        K789.act_quant_dy_int8(dy[:, :12].contiguous(), scale[:12].contiguous())
    with pytest.raises(ValueError, match="scale"):
        K789.act_quant_dy_int8(dy, scale[:32].contiguous())
    with pytest.raises(ValueError, match="CUDA device"):
        K789.int8_dx_gemm(dyq, q.cpu(), gs)
    with pytest.raises(TypeError):
        K789.int8_dx_gemm(dyq.float(), q, gs)
    with pytest.raises(ValueError, match="multiple of 8"):
        K789.int8_dx_gemm(dyq[:, :20].contiguous(), q[:20].contiguous(), gs)
    with pytest.raises(ValueError, match="of 16"):
        K789.int8_dx_gemm(dyq, q[:, :24].contiguous(), gs)
    with pytest.raises(ValueError, match="do not fit"):
        K789.int8_dx_gemm(dyq, q[:48].contiguous(), gs)


@pytest.mark.parametrize("case", ["w8a8_ste", "w8a8_int8_backward", "weight_only_lora", "w8a8_lora"])
def test_quantized_linear_backward_card_vs_cpu(cuda, case):
    """``linear``'s quantized branches with their gradients, the card's route
    (K7 + K8 or K9 forward, the STE's bf16 product or K10 + K11, the LoRA
    addend in K8's / K9's epilogue) against the same bf16 layer on the CPU
    (the plain versions): K7 + K8 and the int8 dx bit for bit, K9 and the
    bf16 products within the bf16 bound (other f32 summation orders; the
    weight-only dx rounds dy * scale to bf16 on the card only)."""
    from spatialrgpt_tpu_torch.ops import layers

    rng = np.random.default_rng(len(case))
    lin = torch.nn.Linear(256, 512, bias=True)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(rng.standard_normal((512, 256)).astype(np.float32)) * 256**-0.5)
        lin.bias.copy_(torch.tensor(rng.standard_normal(512).astype(np.float32)))
    ql = layers.QuantLinear.from_linear(lin, 8, act_quant=case != "weight_only_lora")
    x = _rand(rng, 3, 70, 256, device="cpu")
    co = torch.tensor(rng.standard_normal((3, 70, 512)).astype(np.float32))
    lora = None
    if case.endswith("lora"):
        a = torch.tensor(rng.standard_normal((256, 8)).astype(np.float32)) * 0.1
        b = torch.tensor(rng.standard_normal((8, 512)).astype(np.float32)) * 0.1
        lora = (a.to(torch.bfloat16), b.to(torch.bfloat16))
    layers.enable_int8_backward(case == "w8a8_int8_backward")
    try:
        runs = []
        for dev in (cuda, torch.device("cpu")):
            mod = layers.QuantLinear(256, 512, 8, ql.a8, bias=True, dtype=torch.bfloat16, device=dev)
            mod.q.copy_(ql.q)
            mod.scale.copy_(ql.scale)
            with torch.no_grad():
                mod.bias.copy_(ql.bias)
            ab = None
            if lora is not None:
                ab = [t.to(dev).requires_grad_(True) for t in lora]
                mod.lora = layers.LoraBranch(ab[0], ab[1], 2.0)
            xd = x.to(dev).requires_grad_(True)
            y = layers.linear(xd, mod)
            (y.float() * co.to(dev)).sum().backward()
            runs.append([t.detach().cpu() for t in (y, xd.grad, *([] if ab is None else [t.grad for t in ab]))])
    finally:
        layers.enable_int8_backward(False)
    (y_card, dx_card, *lo_card), (y_cpu, dx_cpu, *lo_cpu) = runs
    if case in ("w8a8_ste", "w8a8_int8_backward"):
        assert torch.equal(y_card, y_cpu)
    else:
        _bf16_close(y_card, y_cpu)
    if case == "w8a8_int8_backward":
        assert torch.equal(dx_card, dx_cpu)
    else:
        _bf16_close(dx_card, dx_cpu)
    for got, want in zip(lo_card, lo_cpu):
        assert got is not None and float((got.float() - want.float()).norm() / want.float().norm()) < 1e-2


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
    fast = generate(model, cfg, inputs, plens, max_new_tokens=steps + 1, eos_token_id=-1, attn_impl="onepass",
                    kv_quant=True)
    # tower, 2 layers at 4 x 16 rows: qkv (one K7), out, fc1 W8A8, fc2
    # contracts (K9); each decoder layer at 24 prefill rows and at 2 decode
    # rows: qkv (one K7, q on K8, k/v contract: K9), o, gate/up (one K7),
    # down (K9); lm_head W8A8 at 2 rows
    tower = 2
    per_layer = {"act_quant_int8": 3, "w8a8_gemm": 4, "w8_gemm": 3}
    want = {name: tower * {"act_quant_int8": 3, "w8a8_gemm": 5, "w8_gemm": 1}[name]
            + (1 + steps) * (2 * per_layer[name] + (name != "w8_gemm")) for name in per_layer}
    want.update(act_quant_dy_int8=0, int8_dx_gemm=0)  # the int8 backward's kernels: no backward here
    assert K789.launches == want
    monkeypatch.setattr(layers, "QUANT_KERNELS", False)
    plain = generate(model, cfg, inputs, plens, max_new_tokens=steps + 1, eos_token_id=-1, attn_impl="onepass",
                     kv_quant=True)
    assert K789.launches == want
    assert fast.tokens.shape == (2, steps + 1) and ((fast.tokens >= 0) & (fast.tokens < 64)).all()
    assert torch.equal(fast.tokens, plain.tokens)
    rel = (fast.first_logits - plain.first_logits).norm() / plain.first_logits.norm()
    assert float(rel) < 0.05


class _ByteTokenizer:
    """Characters as ids 3..66 (``<mask>`` and ``<depth>`` as 60 and 61), no
    BOS: just what the eval runners call."""

    bos_token_id, eos_token_id, pad_token_id = None, 63, 0
    model_max_length = 512

    def __call__(self, text, **kw):
        ids, i = [], 0
        while i < len(text):
            for tok, tid in (("<mask>", 60), ("<depth>", 61)):
                if text.startswith(tok, i):
                    ids.append(tid)
                    i += len(tok)
                    break
            else:
                ids.append(3 + ord(text[i]) % 56)
                i += 1
        return types.SimpleNamespace(input_ids=ids)

    def decode(self, ids, skip_special_tokens=False):
        return "".join(chr(32 + int(t) % 90) for t in ids)


def test_tiny_eval_runners_on_the_card(cuda, tmp_path):
    """``run_bench`` (RGB as depth, bf16 cache; then W8A8 + int8 KV),
    ``run_region_cls`` and ``run_vqa`` on a tiny model on the card, with no
    ``device`` (the card is the default): K1 and K2 per batch, K3 and K7-K9
    only in the W8A8 run, and the caller's bf16 model unchanged by it."""
    import json

    from PIL import Image

    from spatialrgpt_tpu_torch.data.preprocess import SiglipProcessor, rle_encode
    from spatialrgpt_tpu_torch.eval import region_cls, spatial_bench, vqa

    cfg = dataclasses.replace(_tiny_quant_cfg(), model_max_length=512)
    rng = np.random.default_rng(9)
    Image.fromarray(rng.integers(0, 256, (60, 80, 3), np.uint8)).save(tmp_path / "a.jpg")
    mask = np.zeros((60, 80), np.uint8)
    mask[5:30, 10:50] = 1
    conv = [{"from": "human", "value": "<image>\nHow wide is <mask>?"}, {"from": "gpt", "value": "1 m"},
            {"from": "human", "value": "And tall?"}, {"from": "gpt", "value": "2 m"}]
    ann = [{"id": f"q{i}", "image_info": {"file_path": "a.jpg", "height": 60, "width": 80}, "rle": [rle_encode(mask)],
            "qa_info": {"type": "quantitative", "category": "width_data"}, "conversations": conv} for i in range(3)]
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    model = init_random(cfg, cuda, torch.bfloat16, seed=0)
    tower = cfg.vision.num_hidden_layers + 1 + cfg.vision.select_layer  # the layers that run
    tup = (_ByteTokenizer(), model, cfg, SiglipProcessor(size=56))
    before = {k: t.clone() for k, t in model.state_dict().items()}
    bcfg = spatial_bench.BenchConfig(annotation_file=str(tmp_path / "ann.json"), image_folder=str(tmp_path),
                                     answers_file=str(tmp_path / "out" / "a.jsonl"), conv_mode="v1", batch_size=4,
                                     max_new_tokens=3, prompt_bucket=384, regions_per_image=2, depth_source="rgb")
    for quant in (False, True):
        K1.launches = K2.launches = K3.launches = 0
        for name in K789.launches:
            K789.launches[name] = 0
        out = spatial_bench.run_bench(dataclasses.replace(bcfg, w8a8=quant, kv_quant=quant), tup)
        recs = [json.loads(line) for line in open(out)]
        assert len(recs) == 6 and all(len(r["output_ids"]) == 3 for r in recs)
        assert (K1.launches, K2.launches) == (2 * tower, 2 * 2)  # 2 batches of the tower and 2 decoder layers
        assert (K3.launches > 0) == quant and (K789.launches["act_quant_int8"] > 0) == quant
    assert all(torch.equal(t, before[k]) for k, t in model.state_dict().items())
    items = [{"file_name": "a.jpg", "image_info": {"height": 60, "width": 80}, "bbox": [10, 5, 50, 30],
              "category": "cup"}] * 3
    K1.launches = K2.launches = 0
    recs = [json.loads(line) for line in open(region_cls.run_region_cls(
        tup, items, str(tmp_path), answers_file=str(tmp_path / "rc.jsonl"), conv_mode="v1", batch_size=2,
        max_new_tokens=2, prompt_bucket=512))]
    assert len(recs) == 3 and (K1.launches, K2.launches) == (2 * tower, 2 * 2)
    (tmp_path / "q.jsonl").write_text(json.dumps({"question_id": 1, "image": "a.jpg", "text": "What?"}) + "\n")
    vcfg = vqa.VQAConfig(question_file=str(tmp_path / "q.jsonl"), image_folder=str(tmp_path),
                         answers_file=str(tmp_path / "v.jsonl"), conv_mode="v1", max_new_tokens=2, prompt_bucket=512)
    assert len(open(vqa.run_vqa(vcfg, tup)).readlines()) == 1


# ---------------------------------------------------------------------------
# the serving engine
# ---------------------------------------------------------------------------


def _engine_requests(prompts, seed=4, pad_to=16):
    """One batch-1 request per prompt (RGB + depth + 2 masks, pixels on the
    card in bf16), and ``batch(i, j)``: prompts i..j-1 spliced as one batch
    with the same pixels."""
    rng = np.random.default_rng(seed)
    n = len(prompts)
    pix = (rng.standard_normal((n, 56, 56, 3)), rng.standard_normal((n, 56, 56, 3)),
           (rng.random((n, 2, 56, 56)) > 0.5).astype(np.float32), np.ones((n, 2), bool))

    def batch(i, j):
        sb = expand_rows([np.asarray(p, np.int64) for p in prompts[i:j]], None, max_len=64, tokens_per_image=4,
                         mask_token_id=60, depth_token_id=61, regions_per_image=2, pad_to=pad_to)
        inputs = VLMInputs.from_spliced(sb, *(a[i:j] for a in pix), device="cuda", dtype=torch.bfloat16)
        return inputs, sb.segment_ids.sum(axis=1)

    rows = [batch(i, i + 1) for i in range(n)]
    return [r for r, _ in rows], batch, [int(p[0]) for _, p in rows]


def _engine_cfg():
    """The tiny config with eos at -1: every request runs its whole budget."""
    cfg = _tiny_quant_cfg()
    return cfg.replace(llm=dataclasses.replace(cfg.llm, eos_token_id=-1))


_ENGINE_PROMPTS = [[5, IMAGE_TOKEN_INDEX, 60, 61, 8], [IMAGE_TOKEN_INDEX, 7], [1, IMAGE_TOKEN_INDEX, 60, 9, 10],
                   [IMAGE_TOKEN_INDEX, 61, 11, 12, 13, 14], [3, IMAGE_TOKEN_INDEX, 15]]


@pytest.mark.parametrize("kv_quant", [True, False])
def test_tiny_engine_waves_equal_lockstep(cuda, kv_quant):
    """4 requests through 2 slots in two waves of 2 (the second in recycled
    slots), windows of 3 steps: each wave's tokens equal ``generate`` on
    its 2 rows with the same kernels and capacity, bit for bit; K1 and K2
    launch per admission and layer, K3 (int8 cache) per decode step and
    layer of the steps the host runs (the first window's, eager, and the
    captured step; the other three windows replay it), never with the bf16
    cache."""
    cfg = _engine_cfg()
    model = init_random(cfg, cuda, torch.bfloat16, seed=0)
    rows, batch, plens = _engine_requests(_ENGINE_PROMPTS[:4])
    max_new, k = 6, 3
    eng = ServingEngine(model, cfg, num_slots=2, prompt_bucket=16, max_new_tokens=max_new, kv_quant=kv_quant,
                        admit_width=2)
    for m in (K1, K2, K3):
        m.launches = 0
    ids = [eng.submit(r, p, max_new_tokens=max_new) for r, p in zip(rows, plens)]
    done = {r.request_id: r.tokens for r in eng.run_until_drained(num_steps=k)}
    windows = 2 * -(-(max_new - 1) // k)  # two waves
    assert eng.graph_stats == {"captures": 1, "replays": windows - 1, "eager": 1}
    # per admission 2 tower layers (3, select_layer -2) and 2 decoder layers
    assert (K1.launches, K2.launches, K3.launches) == (2 * 2, 2 * 2, 2 * (k + 1) if kv_quant else 0)
    for w in (0, 2):
        inputs, wave_plens = batch(w, w + 2)
        want = generate(model, cfg, inputs, torch.as_tensor(wave_plens, device=cuda), max_new_tokens=max_new,
                        eos_token_id=-1, kv_quant=kv_quant)
        assert [done[ids[w]], done[ids[w + 1]]] == want.tokens.tolist()


def test_tiny_engine_k3_against_plain_under_churn(cuda, monkeypatch):
    """5 requests of 3-7 tokens through 2 slots, windows of 2, async
    readback: the engine on K3 gives the tokens of the same engine with
    K3's plain version in its place (K1, K2 and the projections the same),
    and every length stays in [0, C)."""
    cfg = _engine_cfg()
    model = init_random(cfg, cuda, torch.bfloat16, seed=0)
    rows, _, plens = _engine_requests(_ENGINE_PROMPTS)

    def run():
        eng = ServingEngine(model, cfg, num_slots=2, prompt_bucket=16, max_new_tokens=7, kv_quant=True,
                            async_readback=True)
        ids = [eng.submit(r, p, max_new_tokens=3 + i) for i, (r, p) in enumerate(zip(rows, plens))]
        done = {r.request_id: r.tokens for r in eng.run_until_drained(num_steps=2)}
        assert 0 <= int(eng.lengths.min()) and int(eng.lengths.max()) < eng.capacity
        return [done[i] for i in ids]

    K3.launches = 0
    fast = run()
    assert K3.launches > 0
    monkeypatch.setattr(generate_mod, "decode_attention_int8_flat", K3.decode_attention_int8_flat_plain)
    K3.launches = 0
    plain = run()
    assert K3.launches == 0
    assert [len(t) for t in fast] == [3, 4, 5, 6, 7]
    assert fast == plain


def test_tiny_engine_row_past_the_cache_inside_a_window(cuda):
    """Request A fills the cache (prompt + budget = capacity) and ends
    mid-window; the window's later steps clamp its writes and K3's lengths
    to C - 1, so no device assert: the card synchronizes cleanly, and B,
    decoding beside it through those steps, gets the tokens it gets when A
    takes a single token."""
    cfg = _engine_cfg()
    model = init_random(cfg, cuda, torch.bfloat16, seed=0)
    rows, _, plens = _engine_requests([_ENGINE_PROMPTS[3], _ENGINE_PROMPTS[1]])
    pa, pb = plens

    def run(na):
        eng = ServingEngine(model, cfg, num_slots=2, prompt_bucket=16, max_new_tokens=8, kv_quant=True)
        C = eng.capacity
        ids = [eng.submit(rows[0], pa, max_new_tokens=na(C)), eng.submit(rows[1], pb, max_new_tokens=C - pb)]
        done = {r.request_id: r.tokens for r in eng.run_until_drained(num_steps=8)}
        torch.cuda.synchronize()
        assert int(eng.lengths.max()) == C - 1
        return done[ids[0]], done[ids[1]], C

    a_toks, b_toks, C = run(lambda C: C - pa)
    assert (C - pa - 1) % 8 and C - pb - 1 >= -(-(C - pa - 1) // 8) * 8  # A runs past C while B decodes
    assert len(a_toks) == C - pa and len(b_toks) == C - pb
    assert run(lambda C: 1)[1] == b_toks


def _graph_model(kind: str, cuda):
    """(config, model): the tiny W8A8 dense-MoE decoder (router and experts
    quantized: K7-K9 in every decode step) or the tiny bf16 decoder, both
    with eos at -1."""
    if kind == "w8a8_moe":
        cfg = _family_cfg("mixtral")
        return cfg, init_random_quantized(cfg, cuda, w8a8=True, seed=2)
    cfg = _engine_cfg()
    return cfg, init_random(cfg, cuda, torch.bfloat16, seed=0)


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
@pytest.mark.parametrize("async_readback", [False, True], ids=["sync", "async"])
@pytest.mark.parametrize("kind", ["w8a8_moe", "bf16"])
def test_graphed_engine_equals_eager(cuda, kind, async_readback, sampled):
    """5 requests of 3-9 tokens through 2 slots (admissions between windows
    recycle the slots), windows of 3, the int8 cache, every other request
    sampled where ``sampled``: after every ``step`` the engine whose plain
    decode window replays a CUDA graph and the same engine with the graph
    switched off return the same requests with the same tokens and hold
    equal lengths, last tokens and cache bytes.  ``graph_stats``: one
    capture of the step for greedy windows and one for sampling windows,
    each right after the first (eager) window of its kind, every later
    window of the kind replays; the other engine runs every window
    eagerly."""
    cfg, model = _graph_model(kind, cuda)
    rows, _, plens = _engine_requests(_ENGINE_PROMPTS)
    engines = []
    for graphed in (True, False):
        eng = ServingEngine(model, cfg, num_slots=2, prompt_bucket=16, max_new_tokens=9, kv_quant=True, admit_width=2,
                            async_readback=async_readback)
        assert eng._graph_window
        eng._graph_window = graphed
        for i, (r, p) in enumerate(zip(rows, plens)):
            eng.submit(r, p, max_new_tokens=3 + 2 * i % 7, temperature=0.8 if sampled and i % 2 else 0.0, top_p=0.9,
                       seed=i)
        engines.append(eng)
    done = []
    for _ in range(100):
        finished = [[(r.request_id, r.tokens) for r in eng.step(3)] for eng in engines]
        assert finished[0] == finished[1]
        done += finished[0]
        for a, b in zip(*([eng.lengths, eng.last_token, *eng.cache] for eng in engines)):
            assert torch.equal(a, b)
        if not any(eng.queue or eng.active.any() or eng._pending for eng in engines):
            break
    assert sorted(len(t) for _, t in done) == sorted(3 + 2 * i % 7 for i in range(5))
    graphed, eager = (eng.graph_stats for eng in engines)
    keys = set(engines[0]._graphs)
    assert keys <= {True, False} and (False in keys) == sampled
    windows = eager["eager"]
    assert eager == {"captures": 0, "replays": 0, "eager": windows}
    assert graphed == {"captures": len(keys), "replays": windows - len(keys), "eager": len(keys)}


def test_graph_replay_opens_one_span_per_qgemm_kernel(cuda, tmp_path):
    """The tiny W8A8 MoE engine captures its greedy step's graph in one
    ``step``, with no profiler running; then a profiled ``step`` admits 2
    requests (eager K8 / K9 launches, each in its span) and replays the
    graph 3 times (``engine.replay[3]``, each launch followed by one span
    of each K8 / K9 node, in capture order): the trace holds one ``k8.*`` /
    ``k9.*`` span for each ``srgpt::qgemm::`` kernel,
    ``benchmark/spans.py::gemm_pairs`` pairs them all in order, and
    ``benchmark/graphs.py`` reads every decode window of the slice as
    replayed."""
    import json
    import os
    import sys

    sys.path.append(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark"))
    import graphs
    import spans
    from timeline import SLICE, Timeline

    cfg, model = _graph_model("w8a8_moe", cuda)
    rows, _, plens = _engine_requests(_ENGINE_PROMPTS[:4])
    eng = ServingEngine(model, cfg, num_slots=4, prompt_bucket=16, max_new_tokens=8, kv_quant=True, admit_width=2)
    for r, p in zip(rows[:2], plens[:2]):
        eng.submit(r, p, max_new_tokens=8)
    eng.step(3)
    assert eng.graph_stats == {"captures": 1, "replays": 0, "eager": 1}
    _, _, recorded = eng._graphs[True]
    assert recorded and all(spans.parse_gemm(n) for n in recorded)
    for r, p in zip(rows[2:], plens[2:]):
        eng.submit(r, p, max_new_tokens=8)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):  # the first profiled calls of a process may record no CUDA event
        torch.ones(8, device=cuda).sum()
        torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(SLICE):
            eng.step(3)
            torch.cuda.synchronize()
    assert eng.graph_stats == {"captures": 1, "replays": 1, "eager": 1}
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        tl = Timeline(json.load(f)["traceEvents"])
    names = [n for _, _, n in spans.spans(tl, spans.GEMM.fullmatch)]
    kernels = [n for _, _, n in tl.kernels if spans.QGEMM in n]
    assert len(names) == len(kernels) > 3 * len(recorded)
    assert names[-3 * len(recorded):] == 3 * list(recorded)
    assert spans.gemm_pairs([spans.parse_gemm(n) for n in names], kernels) == [(i, i) for i in range(len(names))]
    assert spans.int8_gemm_roofline({"timeline": tl}) > 0
    assert graphs.decode_replay_share({"timeline": tl}) == 100


def test_tiny_train_main_pallas_against_xla(cuda, tmp_path, monkeypatch):
    """``train/train.py::main`` from argv on the card (no ``device``: the
    card is the default), stage-1 flags on the ``dummy`` mixture with a
    tiny preset: the kernel route launches K1 and K4 as an align step does,
    the plain route none, and their losses agree within 1%."""
    import json

    from chip_smoke import CharTokenizer
    from spatialrgpt_tpu_torch.train import train as train_mod

    cfg = SpatialRGPTConfig(
        llm=LlamaConfig(vocab_size=1024, hidden_size=256, intermediate_size=512, num_hidden_layers=2,
                        num_attention_heads=4, num_key_value_heads=2),
        vision=SiglipVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                                  num_attention_heads=2, image_size=384, patch_size=14),
        projector=ProjectorConfig(mm_hidden_size=32, hidden_size=256),
        region=RegionExtractorConfig(mm_hidden_size=32, hidden_size=256, ada_pool_size=4),
        mask_token_id=1009, depth_token_id=1010,
    )
    monkeypatch.setattr(train_mod, "preset", lambda name: cfg)
    argv = ["--data_mixture", "dummy", "--tune_language_model", "false", "--tune_vision_tower", "false",
            "--per_device_train_batch_size", "4", "--model_max_length", "1024", "--max_steps", "2",
            "--learning_rate", "1e-3", "--regions_per_image", "2"]
    losses, counts = {}, {}
    for impl in ("pallas", "xla"):
        tokenizer = CharTokenizer(size=1009)
        tokenizer.add_tokens(["<mask>", "<depth>"])  # 1009, 1010: the preset's region ids
        K1.launches = 0
        K4.launches = dict.fromkeys(K4.launches, 0)
        out = tmp_path / impl
        assert train_mod.main(argv + ["--attn_impl", impl, "--output_dir", str(out)], tokenizer=tokenizer) == {
            "status": "completed", "step": 2}
        torch.cuda.synchronize()
        counts[impl] = (K1.launches, dict(K4.launches))
        with open(out / "metrics.jsonl") as f:
            losses[impl] = [json.loads(line)["loss"] for line in f]
    assert counts["pallas"] == (4, {"flash_attention_fwd": 8, "flash_attention_bwd_dkv": 4, "flash_attention_bwd_dq": 4})
    assert counts["xla"] == (0, dict.fromkeys(K4.launches, 0))
    for got, want in zip(losses["pallas"], losses["xla"], strict=True):
        assert abs(got - want) <= 0.01 * abs(want), losses


# ---------------------------------------------------------------------------
# the synth pipeline's models
# ---------------------------------------------------------------------------


def _synth_model(which: str, device, dtype):
    """A narrow model of each kind, random from a fixed seed, and its forward
    on a batch of 2 (all of its outputs in a tuple)."""
    from spatialrgpt_tpu_torch.models import owl_vit, ram, swin
    from spatialrgpt_tpu_torch.synth import calibration
    from spatialrgpt_tpu_torch.utils import weights

    scfg = swin.SwinConfig(image_size=192, patch_size=4, embed_dim=64, depths=(2, 2), num_heads=(2, 4),
                           window_size=12)
    if which == "swin":
        model = weights.init_random_ram(ram.RamConfig(swin=scfg, num_tags=8, hidden_size=64), device, dtype, 1).swin
        return model, lambda m, x: (swin.forward(m, x, scfg),), (2, 192, 192, 3)
    if which == "ram":
        cfg = ram.RamConfig(swin=scfg, num_tags=512, hidden_size=128)
        return weights.init_random_ram(cfg, device, dtype, 1), lambda m, x: (ram.forward(m, x, cfg),), (2, 192, 192, 3)
    if which == "owl_vit":
        cfg = owl_vit.OwlViTConfig(
            vision=owl_vit.OwlViTVisionConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2,
                                              intermediate_size=256),
            text=owl_vit.OwlViTTextConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                                          intermediate_size=128),
            projection_dim=64)
        ids = torch.tensor(np.random.default_rng(3).integers(1, 500, (4, 16)), device=device)
        ids[:, -1] = 511  # the end-of-text id: the largest
        return weights.init_random_owl_vit(cfg, device, dtype, 1), lambda m, x: owl_vit.detect(
            m, cfg, x, ids.to(x.device), torch.ones_like(ids, device=x.device)), (2, 768, 768, 3)
    cfg = calibration.CameraNetConfig()
    return weights.init_random_camera_net(cfg, device, dtype, 1), lambda m, x: (calibration.forward(m, x, cfg),), (
        2, 224, 224, 3)


@pytest.mark.parametrize("which", ["swin", "ram", "owl_vit", "camera_net"])
def test_synth_model_forward_card_bf16_vs_cpu_f32(cuda, which):
    """The synth models' forwards on the card in bf16 against the same
    (bf16-rounded) weights in f32 on the CPU: relative L2 < 0.05 per output,
    the bound of the narrow demo pipeline's test."""
    model, fwd, shape = _synth_model(which, "cpu", torch.float32)
    card = model.to(cuda, torch.bfloat16)
    ref = {k: t.detach().float().cpu() for k, t in card.state_dict().items()}
    model_cpu, _, _ = _synth_model(which, "cpu", torch.float32)
    model_cpu.load_state_dict(ref)
    x = torch.tensor(np.random.default_rng(2).standard_normal(shape).astype(np.float32))
    with torch.no_grad():
        got = fwd(card, x.to(cuda))
        want = fwd(model_cpu, x)
    for g, w in zip(got, want, strict=True):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        rel = float((g.float().cpu() - w).norm() / w.norm())
        assert rel < 0.05, (which, rel)


def test_sam_segmenter_launches_k5_once_per_image_and_global_layer(cuda):
    """``make_sam_segmenter`` on the card (no ``device``: the card is the
    default) at SAM's 1024-pixel input with a narrow encoder of one global
    layer: K5 launches once for an image of 3 boxes (B1, the synth path's
    shape), not at all on the plain route, and the mask logits of the two
    routes agree within the demo's bound."""
    from spatialrgpt_tpu_torch.demo.pipeline import synth_photo
    from spatialrgpt_tpu_torch.models import sam as tsam
    from spatialrgpt_tpu_torch.synth import models as smodels
    from spatialrgpt_tpu_torch.utils.weights import init_random_sam_hq

    scfg = tsam.SamConfig(
        vision=tsam.SamVisionConfig(hidden_size=128, num_hidden_layers=2, num_attention_heads=2, intermediate_size=256,
                                    output_channels=128, global_attn_indexes=(1,)),
        prompt_hidden_size=128, decoder_hidden_size=128, decoder_num_heads=4, decoder_mlp_dim=256,
    )
    model = init_random_sam_hq(scfg, cuda, torch.bfloat16, seed=2)
    img = synth_photo(np.random.default_rng(11), 480, 640)
    boxes = [np.array(b, np.float32) for b in ([40, 200, 300, 460], [350, 220, 600, 430], [0, 0, 640, 480])]
    K5.grid_bias_launches = 0
    masks = smodels.make_sam_segmenter(model, scfg)(img, boxes)
    assert K5.grid_bias_launches == 1
    assert len(masks) == 3 and all(m.shape == (480, 640) and m.dtype == bool for m in masks)
    smodels.make_sam_segmenter(model, scfg, attn_impl="xla")(img, boxes)
    assert K5.grid_bias_launches == 1
    x, b = (torch.as_tensor(a, device=cuda) for a in smodels.sam_inputs(img, boxes, scfg))
    fast, _ = tsam.predict_boxes(model, scfg, x, b)
    plain, _ = tsam.predict_boxes(model, scfg, x, b, attn_impl="xla")
    assert float((fast - plain).norm() / plain.norm()) < 0.05


# ---------------------------------------------------------------------------
# the decoder families: Mistral's window, Gemma's head dim 256, Mixtral's MoE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 70, 320, 1000])
@pytest.mark.parametrize("D", [192, 256])
@pytest.mark.parametrize("G", [1, 4])
def test_onepass_d256_kernel_matches_plain(cuda, G, D, S):
    """K2's D = 256 form (64-key tiles, P V in two 128-column halves) against
    its plain version: G 1 (Gemma-7B's MHA) and 4, D 256 and 192 (TMA's zero
    fill pads it to 256), S from one token to 1000.  Rows: one segment,
    right padding, two packed segments, all padding.  Once with no window
    on q/k/v as strided views of one fused projection, once with a window
    of 37 and once of 300 (S 1000: the window binds across many tiles) on
    contiguous tensors."""
    rng = np.random.default_rng(G * 10000 + D * 10 + S + 7)
    Hk = 2
    Hq = G * Hk
    q, k, v = _rand(rng, 4, S, Hq + 2 * Hk, D, device=cuda).split([Hq, Hk, Hk], dim=2)
    seg = torch.ones(4, S, dtype=torch.int32, device=cuda)
    seg[1, S // 2 + 1 :] = 0
    seg[2, S // 3 :] = 2
    seg[3] = 0
    dense = (q.contiguous(), k.contiguous(), v.contiguous())
    for (qq, kk, vv), window in (((q, k, v), None), (dense, 37), (dense, 300)):
        before = K2.launches
        out = K2.onepass_attention(qq, kk, vv, seg, window=window)
        torch.cuda.synchronize()
        assert K2.launches == before + 1
        assert torch.all(out[seg == 0] == 0)
        _bf16_close(out, K2.onepass_attention_plain(qq, kk, vv, seg, window=window))


def test_onepass_d256_bound_separates_a_skipped_key_tile(cuda):
    """At Gemma-7B's prefill heads (Hq = Hk = 16, D 256, S 320) a K2 whose
    queries lose the keys of their own 64-key tile fails the bound that the
    D = 256 form meets."""
    rng = np.random.default_rng(12)
    B, S, H, D = 2, 320, 16, 256
    q, k, v = (_rand(rng, B, S, H, D, device=cuda) for _ in range(3))
    seg = torch.ones(B, S, dtype=torch.int32, device=cuda)
    seg[1, 290:] = 0
    ref = K2.onepass_attention_plain(q, k, v, seg)
    tile = torch.arange(S, device=cuda) // 64
    fault = _masked_attention(q, k, v, _causal_segment_live(seg) & (tile[:, None] != tile[None, :]))
    assert bf16_err_over_bound(K2.onepass_attention(q, k, v, seg), ref) <= 1.0
    assert bf16_err_over_bound(fault, ref) > 1.0


# (M, N, K): Mixtral's router (4096 -> 8) at the prefill's 2560 rows and at
# decode rows; Gemma-7B's gate / up (3072 -> 24,576) and down (24,576 ->
# 3072) at the prefill's and the decode's rows
_FAMILY_PROJECTIONS = [(2560, 8, 4096), (8, 8, 4096), (64, 8, 4096), (2560, 24576, 3072), (2560, 3072, 24576),
                       (8, 24576, 3072), (8, 3072, 24576)]


@pytest.mark.parametrize("M,N,K", _FAMILY_PROJECTIONS)
def test_family_projections(cuda, M, N, K):
    """K8 bit-equal and K9 within the bf16 bound of their plain versions at
    the families' shapes: N = 8 is one ragged channel tile of either form."""
    rng = np.random.default_rng(M + N + K)
    xq, ascale, q, scale, b = _w8a8_case(rng, M, N, K, None, cuda)
    out = _launched("w8a8_gemm", K789.w8a8_gemm, xq, ascale, q, scale)
    assert out.shape == (M, N) and torch.equal(out, K789.w8a8_gemm_plain(xq, ascale, q, scale))
    x = _rand(rng, M, K, device=cuda)
    out = _launched("w8_gemm", K789.w8_gemm, x, q, scale)
    _bf16_close(out, K789.w8_gemm_plain(x, q, scale))


def _family_cfg(family: str, experts_per_tok: int = 2):
    """Tiny composite configs of the three families; Gemma at its head dim
    256 (K2's second form, K3 at D 256)."""
    knobs = {
        "mistral": dict(sliding_window=6),
        "gemma": dict(hidden_act="gelu_tanh", norm_plus_one=True, scale_embeddings=True, explicit_head_dim=256,
                      tie_word_embeddings=True, num_key_value_heads=4),
        "mixtral": dict(num_experts=4, num_experts_per_tok=experts_per_tok),
    }[family]
    base = dict(vocab_size=64, hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, eos_token_id=-1)
    return dataclasses.replace(_tiny_quant_cfg(), llm=LlamaConfig(**{**base, **knobs}))


def _family_batch(cuda):
    sb = expand_rows(
        [np.array([5, IMAGE_TOKEN_INDEX, 60, 61, 8, 9, 10, 11], np.int64), np.array([IMAGE_TOKEN_INDEX, 7], np.int64)],
        None, max_len=64, tokens_per_image=4, mask_token_id=60, depth_token_id=61, regions_per_image=2, pad_to=16,
    )
    rng = np.random.default_rng(5)
    inputs = VLMInputs.from_spliced(
        sb, rng.standard_normal((2, 56, 56, 3)), rng.standard_normal((2, 56, 56, 3)),
        (rng.random((2, 2, 56, 56)) > 0.5).astype(np.float32), np.ones((2, 2), bool),
        device=cuda, dtype=torch.bfloat16,
    )
    return inputs, torch.as_tensor(sb.segment_ids.sum(axis=1), device=cuda)


@pytest.mark.parametrize("family", ["mistral", "gemma", "mixtral"])
def test_tiny_family_generate_runs_the_kernels(cuda, family):
    """A tiny region-QA batch of each family on the card, bf16 weights, the
    int8 cache: K2 once per decoder layer (Gemma's on the D = 256 form),
    K3 once per layer and decode step, and first-token logits within the
    serve checks' bound of the plain route's; Mixtral's sparse route over
    stacked experts within the same bound of its dense route.  Mixtral's
    tokens here take all 4 experts: a tiny random router's top 2 of 4 sit
    near ties that a bf16 rounding of the attention flips (top-2 read 0.065
    on the H100), so its logits would hold the router's discontinuity, not
    the kernels'; the full-width runs keep top 2 of 8 (chip_smoke.py)."""
    from spatialrgpt_tpu_torch.models import llama

    cfg = _family_cfg(family, experts_per_tok=4)
    inputs, plens = _family_batch(cuda)
    model = init_random(cfg, cuda, torch.bfloat16, seed=1)
    K2.launches = K3.launches = 0
    fast = generate(model, cfg, inputs, plens, max_new_tokens=5, attn_impl="onepass", kv_quant=True)
    assert (K2.launches, K3.launches) == (2, 2 * 4)
    plain = generate(model, cfg, inputs, plens, max_new_tokens=5, attn_impl="xla", kv_quant=True)
    assert (K2.launches, K3.launches) == (2, 2 * 4)
    assert ((fast.tokens >= 0) & (fast.tokens < 66)).all()
    rel = (fast.first_logits - plain.first_logits).norm() / plain.first_logits.norm()
    assert float(rel) < 0.05
    if family == "mixtral":
        llama.stack_experts(model.llm)
        sparse_cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, moe_impl="sparse"))
        sparse = generate(model, sparse_cfg, inputs, plens, max_new_tokens=5, attn_impl="onepass", kv_quant=True)
        rel = (sparse.first_logits - fast.first_logits).norm() / fast.first_logits.norm()
        assert float(rel) < 0.05


def test_tiny_mixtral_w8a8_generate_runs_k7_to_k9(cuda, monkeypatch):
    """A tiny W8A8 Mixtral batch on the card: the router and every expert
    quantized; per MoE layer one K7 over x for the router and the experts'
    gate and up, and the tokens equal those of K7-K9's plain versions."""
    from spatialrgpt_tpu_torch.ops import layers

    cfg = _family_cfg("mixtral")
    inputs, plens = _family_batch(cuda)
    model = init_random_quantized(cfg, cuda, w8a8=True, seed=2)
    for name in K789.launches:
        K789.launches[name] = 0
    fast = generate(model, cfg, inputs, plens, max_new_tokens=3, attn_impl="onepass", kv_quant=True)
    # a decoder layer at 32 prefill rows and 2 decode rows: qkv (one K7, q on
    # K8, k / v contract: K9), o (K8); the MoE: one K7 for the router (it
    # contracts: K9) and the 4 experts' gate and up (K8 each), each down K9
    per_layer = {"act_quant_int8": 3, "w8a8_gemm": 1 + 1 + 8, "w8_gemm": 2 + 1 + 4}
    tower = {"act_quant_int8": 3, "w8a8_gemm": 5, "w8_gemm": 1}
    want = {n: 2 * tower[n] + 3 * (2 * per_layer[n] + (n != "w8_gemm")) for n in per_layer}
    want.update(act_quant_dy_int8=0, int8_dx_gemm=0)
    assert K789.launches == want
    monkeypatch.setattr(layers, "QUANT_KERNELS", False)
    plain = generate(model, cfg, inputs, plens, max_new_tokens=3, attn_impl="onepass", kv_quant=True)
    assert torch.equal(fast.tokens, plain.tokens)


# ---------------------------------------------------------------------------
# the families' training: Gemma's tied head backward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grads", ["x", "x_and_w"])
def test_matmul_f32_backward_on_the_card(cuda, monkeypatch, grads):
    """Gemma's tied head on the card (``ops/layers.py::matmul_f32``): the
    f32-output GEMM of bf16 operands and ``MatmulF32``'s backward against
    the f32 products of the same operands, y within f32 summation order
    (1e-5 of its largest value), dx and dw each within one bf16 rounding of the f32 product (its sums run
    in another order).  The table is widened 7000 rows at a time (the last
    chunk ragged); with only dx to make, the backward's peak stays below an
    f32 copy of the table."""
    from spatialrgpt_tpu_torch.ops import layers

    monkeypatch.setattr(layers, "MATMUL_F32_BWD_ROWS", 7000)
    rng = np.random.default_rng(17)
    x = _rand(rng, 300, 1024, device=cuda).requires_grad_()
    w = _rand(rng, 40000, 1024, device=cuda).requires_grad_(grads == "x_and_w")
    g = torch.tensor(rng.standard_normal((300, 40000)).astype(np.float32), device=cuda)
    y = layers.matmul_f32(x, w)
    assert y.dtype == torch.float32
    ref = x.detach().float() @ w.detach().float().t()
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    y.backward(g)
    peak = torch.cuda.max_memory_allocated() - base
    for got, want in ((x.grad, g @ w.detach().float()), (w.grad, g.t() @ x.detach().float())):
        if got is None:
            continue
        assert got.dtype == torch.bfloat16
        diff = (got.float() - want).abs()
        assert bool((diff <= 2.0**-8 * want.abs() + 1e-6 * float(want.abs().max())).all())
    assert (w.grad is None) == (grads == "x")
    if grads == "x":
        assert peak < w.numel() * 4, peak


def _tower(which, device, dtype):
    """A narrow model of each new family at a head dim of its full width
    (CLIP 64, InternViT 128, RADIO 80, MPT 128), its forward, its input's
    shape and its K1 launches (one a layer for CLIP and InternViT)."""
    from spatialrgpt_tpu_torch.config import SiglipVisionConfig as ClipCfg
    from spatialrgpt_tpu_torch.models import clip, intern_vit, mpt, radio
    from spatialrgpt_tpu_torch.utils import weights

    if which == "clip":
        cfg = ClipCfg(hidden_size=256, intermediate_size=512, num_hidden_layers=3, num_attention_heads=4,
                      image_size=336, patch_size=14, select_layer=-2, select_feature="patch")
        return weights.init_random_clip(cfg, device, dtype, 1), lambda m, x: clip.forward_features(m, x, cfg), (
            2, 336, 336, 3), 2
    if which == "intern_vit":
        cfg = intern_vit.InternVisionConfig(hidden_size=384, intermediate_size=768, num_hidden_layers=2,
                                            num_attention_heads=3)
        return weights.init_random_intern_vit(cfg, device, dtype, 1), lambda m, x: intern_vit.forward_features(
            m, x, cfg), (2, 448, 448, 3), 2
    if which == "radio":
        cfg = radio.RadioBackboneConfig(hidden_size=160, num_hidden_layers=4, num_attention_heads=2,
                                        intermediate_size=320)
        return weights.init_random_radio(cfg, device, dtype, 1), lambda m, x: radio.radio_forward_dense(
            m, cfg, x)[1], (2, 256, 384, 3), 0
    cfg = mpt.MPTConfig(d_model=256, n_heads=2, n_layers=2, vocab_size=512)
    ids = torch.tensor(np.random.default_rng(3).integers(0, 512, (2, 40)))
    seg = torch.tensor([[1] * 20 + [2] * 15 + [0] * 5, [1] * 40])

    def fwd(m, x):
        dev = m.transformer.wte.weight.device
        return mpt.forward_logits(m, cfg, ids.to(dev), seg.to(dev))

    return weights.init_random_mpt(cfg, device, dtype, 1), fwd, (1,), 0


@pytest.mark.parametrize("which", ["clip", "intern_vit", "radio", "mpt"])
def test_tower_forward_card_bf16_vs_cpu_f32(cuda, which):
    """The new towers and MPT on the card in bf16 (CLIP and InternViT
    through K1) against the same (bf16-rounded) weights in f32 on the
    CPU: relative L2 < 0.05."""
    model, fwd, shape, k1_layers = _tower(which, "cpu", torch.float32)
    card = model.to(cuda, torch.bfloat16)
    model_cpu, _, _, _ = _tower(which, "cpu", torch.float32)
    model_cpu.load_state_dict({k: t.detach().float().cpu() for k, t in card.state_dict().items()})
    x = torch.tensor(np.random.default_rng(2).standard_normal(shape).astype(np.float32))
    before = K1.launches
    with torch.no_grad():
        got = fwd(card, x.to(cuda))
        torch.cuda.synchronize()
        assert K1.launches == before + k1_layers
        want = fwd(model_cpu, x)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    rel = float((got.float().cpu() - want).norm() / want.norm())
    assert rel < 0.05, (which, rel)


# ---------------------------------------------------------------------------
# the parallel stack: the kernels at a rank's shapes, and NCCL groups
# ---------------------------------------------------------------------------

# llama3-8b at degree 4: Hq 8, Hk 2, D 128 a rank (K4 also at sp 8: Hq 4, Hk 1)


@pytest.mark.parametrize("S,Hq,Hk", [(4096, 8, 2), (16384, 8, 2), (4096, 4, 1)])
def test_flash_kernels_at_rank_local_shapes(cuda, S, Hq, Hk):
    """K4's three kernels at Ulysses' local shapes (one row of the align
    step's packed rows at sp 4 and 8, one long row at sp 4) against their
    plain versions."""
    rng = np.random.default_rng(11)
    q, dout = _rand(rng, 1, S, Hq, 128, device=cuda), _rand(rng, 1, S, Hq, 128, device=cuda)
    k, v = (_rand(rng, 1, S, Hk, 128, device=cuda) for _ in range(2))
    seg = torch.ones(1, S, dtype=torch.int32, device=cuda)
    if S == 4096:
        for i in range(4):
            seg[0, i * 1000 : (i + 1) * 1000] = i + 1
        seg[0, 4000:] = 0
    _check_flash_kernels(q, k, v, dout, seg, None)


def test_onepass_and_decode_kernels_at_rank_local_shapes(cuda):
    """K2 at the tensor-parallel prefill (B8 S320 Hq8 Hk2 D128) and K3 at the
    tensor-parallel decode against a rank's kv heads of the int8 cache (B8
    C352 Hq8 Hk2 D128) against their plain versions."""
    from spatialrgpt_tpu_torch.ops.quant import quantize_kv

    rng = np.random.default_rng(12)
    B, S, Hq, Hk, D = 8, 320, 8, 2, 128
    q, k, v = _rand(rng, B, S, Hq, D, device=cuda), _rand(rng, B, S, Hk, D, device=cuda), _rand(rng, B, S, Hk, D,
                                                                                                  device=cuda)
    seg = torch.zeros(B, S, dtype=torch.int32, device=cuda)
    for b in range(B):
        seg[b, : S - 3 * b - 15] = 1
    _bf16_close(K2.onepass_attention(q, k, v, seg), K2.onepass_attention_plain(q, k, v, seg))
    C = 352
    q3 = _rand(rng, B, Hq, D, device=cuda)
    kq, ks = quantize_kv(_rand(rng, B, C, Hk, D, device=cuda))
    vq, vs = quantize_kv(_rand(rng, B, C, Hk, D, device=cuda))
    kq, vq = kq.reshape(B, C, Hk * D), vq.reshape(B, C, Hk * D)
    lengths = torch.tensor([0, C - 1, 5, 63, 64, 200, 305, 330], dtype=torch.int32, device=cuda)
    K3.check_shape(C, Hq, Hk, D)
    _bf16_close(K3.decode_attention_int8_flat(q3, kq, ks, vq, vs, lengths, Hk),
                K3.decode_attention_int8_flat_plain(q3, kq, ks, vq, vs, lengths, Hk))


@pytest.mark.parametrize("M,N,K", [(2560, 1024, 4096), (2560, 256, 4096), (2560, 3584, 4096), (2560, 4096, 1024),
                                   (2560, 4096, 3584), (64, 32065, 4096), (64, 1024, 4096), (64, 4096, 1024)])
def test_w8a8_kernel_at_rank_local_shapes(cuda, M, N, K):
    """K8 at the tensor-parallel W8A8 projections' slices (fan-out q, k / v,
    gate / up and the vocabulary's quarter with its two extra rows; fan-in
    wo and down), prefill and decode rows: bit-equal to its plain
    version."""
    g = torch.Generator(device=cuda).manual_seed(M + N + K)
    xq = torch.randint(-127, 128, (M, K), generator=g, device=cuda, dtype=torch.int8)
    q = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8)
    ascale = torch.rand(M, generator=g, device=cuda) * 0.05 + 1e-3
    scale = torch.full((N,), K**-0.5 * 3.0 / 127.0, device=cuda)
    assert torch.equal(K789.w8a8_gemm(xq, ascale, q, scale), K789.w8a8_gemm_plain(xq, ascale, q, scale))


@pytest.mark.parametrize("form", _AQ_FORCED)
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("M", sorted(set(_AQ_M) | {2560}))
@pytest.mark.parametrize("K", [4096, 14336])
def test_act_quant_split_form_at_rank_local_shapes(cuda, monkeypatch, K, M, tp, form):
    """K7's split form on the tensor-parallel fan-in slices of wo (K 4096)
    and down (K 14,336) at tp 2 and 4, in the form the wrapper picks for
    the slice and in each form forced: each slice's row maxima (pass 1) are
    this slice's, and after their maximum over the slices (the all-reduce
    MAX, here a local maximum) pass 2 gives each slice K7's int8 columns
    and scales of the whole rows, bit for bit, and its plain version the
    same; one count a call."""
    x = _quant_rows(np.random.default_rng(K + M + tp), M, K, cuda)
    whole_q, whole_s = K789.act_quant_int8(x)  # the whole rows in the picked form
    _force_aq_form(monkeypatch, form)
    parts = x.chunk(tp, dim=1)
    row_max = torch.stack([p.float().abs().amax(dim=1) for p in parts]).amax(dim=0)
    for i, part in enumerate(parts):
        part = part.contiguous()
        seen = []

        def reduce_max(amax):
            seen.append(amax.clone())
            amax.copy_(torch.maximum(amax, row_max))

        before = K789.launches["act_quant_int8"]
        xq, s = K789.act_quant_int8(part, reduce_max)
        assert K789.launches["act_quant_int8"] == before + 1
        assert torch.equal(seen[0], part.float().abs().amax(dim=1))
        cols = slice(i * part.shape[1], (i + 1) * part.shape[1])
        assert torch.equal(xq, whole_q[:, cols]) and torch.equal(s, whole_s)
        pq, ps = K789.act_quant_int8_plain(part, lambda a: a.copy_(torch.maximum(a, row_max)))
        assert torch.equal(xq, pq) and torch.equal(s, ps)


@pytest.mark.parametrize("M,N,K", [(64, 4096, 3584), (2560, 4096, 3584)])
def test_w8_kernel_at_rank_local_shapes(cuda, M, N, K):
    """K9 at the tensor-parallel decode's down slice (and an admission's)
    within the bf16 bound of its plain version."""
    g = torch.Generator(device=cuda).manual_seed(M + K)
    x = torch.randn(M, K, generator=g, device=cuda).to(torch.bfloat16)
    q = torch.randint(-127, 128, (N, K), generator=g, device=cuda, dtype=torch.int8)
    scale = torch.full((N,), K**-0.5 * 3.0 / 127.0, device=cuda)
    _bf16_close(K789.w8_gemm(x, q, scale), K789.w8_gemm_plain(x, q, scale))


def _cards(world):
    n = torch.cuda.device_count()
    if n < world:
        pytest.skip(f"needs {world} CUDA cards for {world} NCCL ranks; this machine has {n}")


def _nccl_sp_case(kind, q, k, v, seg):
    """On each NCCL rank: ``kind`` attention over the whole group on the
    rank's contiguous chunk (f32 on its card, Ulysses' local attention the
    plain route); the chunk's output and the gradients of sum(out**2)."""
    import torch.distributed as dist

    from spatialrgpt_tpu_torch.parallel import ring, ulysses

    r, n = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", r)
    sl = slice(r * q.shape[1] // n, (r + 1) * q.shape[1] // n)
    ins = [torch.tensor(t[:, sl], device=dev).requires_grad_() for t in (q, k, v)]
    s = torch.tensor(seg[:, sl], device=dev)
    if kind == "ring":
        out = ring.ring_attention(*ins, s, group=dist.group.WORLD)
    else:
        out = ulysses.ulysses_attention(*ins, s, dist.group.WORLD)
    out.square().sum().backward()
    return [t.detach().cpu().numpy() for t in (out, *(i.grad for i in ins))]


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
@pytest.mark.parametrize("world", [2, 4])
def test_nccl_sequence_parallel_matches_one_card(world, kind):
    """Ring and Ulysses attention over 2 and 4 NCCL ranks, one card each:
    the assembled output and gradients equal the one-card plain attention
    (f32, atol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA cards")
    _cards(world)
    from spatialrgpt_tpu_torch.ops.prefill_attention import onepass_attention_plain
    from spatialrgpt_tpu_torch.parallel.launch import run_ranks

    rng = np.random.default_rng(13)
    q = rng.standard_normal((2, 256, 8, 64)).astype(np.float32)
    k, v = (rng.standard_normal((2, 256, 4, 64)).astype(np.float32) for _ in range(2))
    seg = np.ones((2, 256), np.int32)
    seg[0, 128:] = 2
    seg[1, -16:] = 0
    results = run_ranks(_nccl_sp_case, world, kind, q, k, v, seg, device="cuda", timeout_s=300)
    ins = [torch.tensor(t, device="cuda").requires_grad_() for t in (q, k, v)]
    ref = onepass_attention_plain(*ins, segment_ids=torch.tensor(seg, device="cuda"))
    ref.square().sum().backward()
    want = [t.detach().cpu().numpy() for t in (ref, *(i.grad for i in ins))]
    for i, w in enumerate(want):
        got = np.concatenate([r[i] for r in results], axis=1)
        np.testing.assert_allclose(got, w, atol=1e-4, rtol=1e-4)


def _nccl_tp_case(cfg):
    """On each NCCL rank: greedy tokens of a tiny bf16 model's ``generate``
    (the int8 cache, the kernels) on the rank's slice of the decoder."""
    import torch.distributed as dist

    from spatialrgpt_tpu_torch.parallel.mesh import make_mesh, tp_shard_model

    dev = torch.device("cuda", dist.get_rank())
    model = tp_shard_model(init_random(cfg, dev, torch.bfloat16, seed=0), make_mesh(tp=dist.get_world_size()))
    return _tiny_generate_tokens(model, cfg, dev)


def _tiny_generate_tokens(model, cfg, dev):
    rng = np.random.default_rng(14)
    size = cfg.vision.image_size
    rows = [np.asarray([1, 5, IMAGE_TOKEN_INDEX, cfg.mask_token_id] + list(rng.integers(3, 60, 20)), np.int64)
            for _ in range(2)]
    sb = expand_rows(rows, None, max_len=128, tokens_per_image=cfg.tokens_per_image,
                     mask_token_id=cfg.mask_token_id, depth_token_id=cfg.depth_token_id, regions_per_image=1,
                     pad_to=64)
    inputs = VLMInputs.from_spliced(sb, rng.standard_normal((2, size, size, 3)).astype(np.float32),
                                    rng.standard_normal((2, size, size, 3)).astype(np.float32),
                                    (rng.random((2, 1, size, size)) > 0.5).astype(np.float32), np.ones((2, 1), bool),
                                    dev, dtype=torch.bfloat16)
    out = generate(model, cfg, inputs, inputs.segment_ids.sum(dim=1), max_new_tokens=6, eos_token_id=-1,
                   kv_quant=True)
    return out.tokens.cpu().numpy()


@pytest.mark.parametrize("world", [2, 4])
def test_nccl_tensor_parallel_generate_matches_one_card(world):
    """``generate`` at tp = 2 and 4 over NCCL ranks, one card each (K1-K3 on
    each rank's heads): every rank's greedy tokens equal the one-card
    run's."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA cards")
    _cards(world)
    from spatialrgpt_tpu_torch.parallel.launch import run_ranks

    cfg = SpatialRGPTConfig(
        llm=LlamaConfig(vocab_size=64, hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
                        num_attention_heads=8, num_key_value_heads=4, max_position_embeddings=256),
        vision=SiglipVisionConfig(hidden_size=144, intermediate_size=256, num_hidden_layers=2,
                                  num_attention_heads=2, image_size=56, patch_size=14),
        projector=ProjectorConfig(mm_hidden_size=144, hidden_size=512),
        region=RegionExtractorConfig(mm_hidden_size=144, hidden_size=512, ada_pool_size=4),
        mask_token_id=60, depth_token_id=61)
    want = _tiny_generate_tokens(init_random(cfg, torch.device("cuda"), torch.bfloat16, seed=0), cfg,
                                 torch.device("cuda"))
    for got in run_ranks(_nccl_tp_case, world, cfg, device="cuda", timeout_s=300):
        np.testing.assert_array_equal(got, want)
