"""Port parity for the three attention kernels of the serving slice.

On the CPU: each kernel's plain PyTorch version against the Pallas kernel
it replaces, run in interpret mode as the JAX package's own tests run it,
in fp32 on the same numpy inputs (tolerance: fp32 accumulation order).
Then the wrappers' dispatch: a CPU tensor takes the plain version without
counting a launch, and what the CUDA kernels do not take raises before
any pointer reaches C (checked on ``meta`` tensors).  The kernels
themselves are compared with their plain versions on the card by
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu.ops.decode_attention import decode_attention_int8_flat as j_decode
from spatialrgpt_tpu.ops.prefill_attention import onepass_attention as j_onepass
from spatialrgpt_tpu.ops.vit_attention import vit_attention as j_vit
from spatialrgpt_tpu_torch.ops import decode_attention as K3
from spatialrgpt_tpu_torch.ops import prefill_attention as K2
from spatialrgpt_tpu_torch.ops import vit_attention as K1

ATOL = 2e-5  # fp32 on both sides: summation order only


def _qkv(rng, B, S, Hq, Hk, D):
    return (
        rng.standard_normal((B, S, Hq, D)).astype(np.float32),
        rng.standard_normal((B, S, Hk, D)).astype(np.float32),
        rng.standard_normal((B, S, Hk, D)).astype(np.float32),
    )


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _int8_cache(rng, B, C, Hk, D):
    kq = rng.integers(-127, 128, (B, C, Hk * D)).astype(np.int8)
    vq = rng.integers(-127, 128, (B, C, Hk * D)).astype(np.int8)
    ks = rng.uniform(0.002, 0.03, (B, C, Hk)).astype(np.float32)
    vs = rng.uniform(0.002, 0.03, (B, C, Hk)).astype(np.float32)
    return kq, ks, vq, vs


# ---------------------------------------------------------------------------
# plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S,valid_len", [(100, None), (128, 100), (64, None)])
def test_vit_plain_matches_pallas(S, valid_len):
    """Ragged S (padded to 128 inside the Pallas kernel), a pre-padded input
    with valid_len (every row compared, padded queries included), and the
    SigLIP head dim 72 at a small head count."""
    q, k, v = _qkv(np.random.default_rng(S), 2, S, 2, 2, 72)
    want = np.asarray(j_vit(*_j(q, k, v), interpret=True, valid_len=valid_len))
    got = K1.vit_attention_plain(*_t(q, k, v), valid_len=valid_len).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("hq,hk,S,window", [(4, 2, 100, None), (2, 2, 100, None), (4, 2, 128, 16)])
def test_onepass_plain_matches_pallas(hq, hk, S, window):
    """GQA and MHA, packed segments, a fully padded row, ragged S, window."""
    q, k, v = _qkv(np.random.default_rng(hq + S), 3, S, hq, hk, 32)
    seg = np.zeros((3, S), np.int32)
    seg[0, :40] = 1
    seg[0, 40:80] = 2  # two packed segments + a padded tail
    seg[1, : S - 9] = 1  # right-padded row
    # row 2 stays segment 0 everywhere: a fully padded row gives zeros
    want = np.asarray(j_onepass(*_j(q, k, v), segment_ids=jnp.asarray(seg), window=window, interpret=True))
    got = K2.onepass_attention_plain(*_t(q, k, v), segment_ids=torch.tensor(seg), window=window).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)
    assert np.all(got[2] == 0.0) and np.all(got[0, 80:] == 0.0)


@pytest.mark.parametrize("hq,hk", [(4, 2), (2, 2)])
def test_decode_plain_matches_pallas(hq, hk):
    """GQA and MHA against the int8 flat cache; lengths include 0 (one live
    position) and C - 1 (all live)."""
    rng = np.random.default_rng(hq)
    B, C, D = 4, 24, 8
    q = rng.standard_normal((B, hq, D)).astype(np.float32)
    kq, ks, vq, vs = _int8_cache(rng, B, C, hk, D)
    lengths = np.array([0, C - 1, 7, 13], np.int32)
    want = np.asarray(j_decode(*_j(q, kq, ks, vq, vs, lengths), n_heads=hk, interpret=True, block_c=8))
    got = K3.decode_attention_int8_flat_plain(*_t(q, kq, ks, vq, vs, lengths), hk).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)


def test_causal_attention_routes_match_jax_xla():
    """ops/attention.py: "xla" and "onepass" (the plain path on a CPU
    tensor) both equal the reference's XLA path; an unknown impl raises."""
    from spatialrgpt_tpu.ops.attention import causal_attention as j_causal
    from spatialrgpt_tpu_torch.ops.attention import causal_attention

    q, k, v = _qkv(np.random.default_rng(11), 2, 40, 4, 2, 16)
    seg = np.ones((2, 40), np.int32)
    seg[1, 25:] = 0
    want = np.asarray(j_causal(*_j(q, k, v), segment_ids=jnp.asarray(seg), impl="xla"))
    for impl in ("xla", "onepass"):
        got = causal_attention(*_t(q, k, v), segment_ids=torch.tensor(seg), impl=impl).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)
    with pytest.raises(ValueError, match="unknown attention impl"):
        causal_attention(*_t(q, k, v), impl="pallas")


# ---------------------------------------------------------------------------
# the bound that holds each kernel against its plain version on the card
# ---------------------------------------------------------------------------


def _bf16(rng, *shape):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _causal_gqa(q, k, v, seg, drop_rows=slice(0, 0), drop_keys=slice(0, 0)):
    """K2's function written out with a key mask: causal within a segment,
    and keys ``drop_keys`` left out for the query rows ``drop_rows``."""
    S, D = q.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    kk, vv = (t.float().repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * D**-0.5
    i = torch.arange(S)
    ok = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0) & (i[:, None] >= i[None, :])
    ok[:, drop_rows, drop_keys] = False
    p = torch.softmax(torch.where(ok[:, None], s, torch.full_like(s, -torch.inf)), dim=-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vv).to(torch.bfloat16)


@pytest.mark.parametrize("kernel", ["vit_attention", "onepass_attention", "decode_attention_int8_flat"])
def test_bound_rejects_a_kernel_that_skips_a_key_tile(kernel):
    """``bf16_err_over_bound`` at the main path's head dims and lengths, in
    bf16: a kernel that left out the 64 keys [64, 128) (for K2 only in the
    query rows from 128 on, where ~200-300 keys are live) would exceed it.
    Such a kernel's output is the plain function with those keys masked.
    K1 and K3 mask them by moving them past ``valid_len`` / ``lengths``
    (attention is invariant to the order of its keys)."""
    from spatialrgpt_tpu_torch.ops._checks import bf16_err_over_bound

    rng = np.random.default_rng(5)
    tile = list(range(64, 128))
    if kernel == "vit_attention":
        S = 729
        q, k, v = (_bf16(rng, 1, S, 2, 72) for _ in range(3))
        ref = K1.vit_attention_plain(q, k, v)
        order = list(range(64)) + list(range(128, S)) + tile
        fault = K1.vit_attention_plain(q, k[:, order], v[:, order], valid_len=S - 64)
    elif kernel == "onepass_attention":
        S = 320
        q, k, v = _bf16(rng, 1, S, 4, 128), _bf16(rng, 1, S, 2, 128), _bf16(rng, 1, S, 2, 128)
        seg = torch.ones(1, S, dtype=torch.int32)
        seg[:, S - 15 :] = 0
        ref = K2.onepass_attention_plain(q, k, v, seg)
        # the masked reimplementation itself stays within the bound
        assert bf16_err_over_bound(_causal_gqa(q, k, v, seg), ref) <= 1.0
        fault = _causal_gqa(q, k, v, seg, drop_rows=slice(128, S), drop_keys=slice(64, 128))
    else:
        C, Hk = 352, 2
        q = _bf16(rng, 2, 8, 128)
        kq, ks, vq, vs = _t(*_int8_cache(rng, 2, C, Hk, 128))
        lengths = torch.tensor([330, 200], dtype=torch.int32)
        ref = K3.decode_attention_int8_flat_plain(q, kq, ks, vq, vs, lengths, Hk)
        order = list(range(64)) + list(range(128, C)) + tile
        kq, ks, vq, vs = (t[:, order] for t in (kq, ks, vq, vs))
        fault = K3.decode_attention_int8_flat_plain(q, kq, ks, vq, vs, lengths - 64, Hk)
    assert bf16_err_over_bound(ref, ref) == 0.0
    assert bf16_err_over_bound(fault, ref) > 1.0


# ---------------------------------------------------------------------------
# wrapper dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_without_a_launch(monkeypatch):
    for mod in (K1, K2, K3):
        monkeypatch.setattr(mod, "launches", 0)
    rng = np.random.default_rng(3)
    q, k, v = _t(*_qkv(rng, 1, 20, 4, 2, 16))
    qv = q[:, :, :2]
    torch.testing.assert_close(K1.vit_attention(qv, qv, qv), K1.vit_attention_plain(qv, qv, qv), rtol=0, atol=0)
    torch.testing.assert_close(K2.onepass_attention(q, k, v), K2.onepass_attention_plain(q, k, v), rtol=0, atol=0)
    cache = _t(*_int8_cache(rng, 1, 20, 2, 16))
    args = (q[:, 0], *cache, torch.tensor([9], dtype=torch.int32), 2)
    torch.testing.assert_close(
        K3.decode_attention_int8_flat(*args), K3.decode_attention_int8_flat_plain(*args), rtol=0, atol=0
    )
    assert (K1.launches, K2.launches, K3.launches) == (0, 0, 0)


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


def test_wrappers_reject_what_the_kernels_do_not_take():
    """Dtype and shape are checked first, the device last: on meta tensors
    a good call fails only for not being on a CUDA card."""
    with pytest.raises(TypeError):
        K1.vit_attention(*(_meta(1, 8, 2, 72, dtype=torch.float32),) * 3)
    with pytest.raises(ValueError, match="multiple of 8"):
        K1.vit_attention(*(_meta(1, 8, 2, 12),) * 3)
    with pytest.raises(ValueError, match="CUDA"):
        K1.vit_attention(*(_meta(1, 8, 2, 72),) * 3)
    with pytest.raises(ValueError, match="dividing 64"):
        K2.onepass_attention(_meta(1, 8, 6, 64), _meta(1, 8, 4, 64), _meta(1, 8, 4, 64))
    with pytest.raises(ValueError, match="at most 128|<= 128"):
        K2.onepass_attention(_meta(1, 8, 4, 256), _meta(1, 8, 2, 256), _meta(1, 8, 2, 256))
    with pytest.raises(ValueError, match="CUDA"):
        K2.onepass_attention(_meta(1, 8, 4, 128), _meta(1, 8, 2, 128), _meta(1, 8, 2, 128))
    B, C, Hk, D = 2, 16, 2, 128
    good = dict(
        q=_meta(B, 8, D), k_q=_meta(B, C, Hk * D, dtype=torch.int8), k_s=_meta(B, C, Hk, dtype=torch.float32),
        v_q=_meta(B, C, Hk * D, dtype=torch.int8), v_s=_meta(B, C, Hk, dtype=torch.float32),
        lengths=_meta(B, dtype=torch.int32), n_heads=Hk,
    )
    with pytest.raises(TypeError):
        K3.decode_attention_int8_flat(**{**good, "lengths": _meta(B, dtype=torch.int64)})
    with pytest.raises(ValueError, match="k_q"):
        K3.decode_attention_int8_flat(**{**good, "k_q": _meta(B, C + 1, Hk * D, dtype=torch.int8)})
    with pytest.raises(ValueError, match="CUDA"):
        K3.decode_attention_int8_flat(**good)
