"""Port parity for the attention kernels: K1-K3 of the serving slice and K4
(flash attention, forward and backward) of the training step.

On the CPU: each kernel's plain PyTorch version against the Pallas kernel
it replaces, run in interpret mode as the JAX package's own tests run it,
in fp32 on the same numpy inputs (tolerance: fp32 accumulation order).
Then the wrappers' dispatch: a CPU tensor takes the plain version without
counting a launch, and what the CUDA kernels do not take raises before
any pointer reaches C (checked on ``meta`` tensors).  The kernels
themselves are compared with their plain versions on the card by
tests/test_torch_gpu.py.  Gradients: K4's plain backward and the
backward of K1's and K2's ``autograd.Function`` against ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu.ops import flash_attention as jflash
from spatialrgpt_tpu.ops.attention import causal_attention as j_causal
from spatialrgpt_tpu.ops.decode_attention import decode_attention_int8_flat as j_decode
from spatialrgpt_tpu.ops.prefill_attention import onepass_attention as j_onepass
from spatialrgpt_tpu.ops.vit_attention import vit_attention as j_vit
from spatialrgpt_tpu_torch.ops import decode_attention as K3
from spatialrgpt_tpu_torch.ops import flash_attention as K4
from spatialrgpt_tpu_torch.ops import prefill_attention as K2
from spatialrgpt_tpu_torch.ops import vit_attention as K1
from spatialrgpt_tpu_torch.ops._autograd import KernelForwardPlainGrad
from test_torch_gpu import DECODE_ROUNDING_REL, decode_f32_p, decode_rounding_case

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


def test_decode_plain_rounds_p_as_pallas():
    """On the inputs of the card's K3 rounding test (the serve cache's
    shape, one Pallas block), the plain version rounds P * v_scale to bf16
    where the Pallas kernel does (decode_attention.py:124): within the
    test's relative L2 of the reference, while an f32 P lies outside it, so
    that test tells the two roundings apart."""
    q, kq, ks, vq, vs, lengths, hk = decode_rounding_case(np.random.default_rng(21), "cpu")
    jin = _j(q.float().numpy(), kq.numpy(), ks.numpy(), vq.numpy(), vs.numpy(), lengths.numpy())
    jin[0] = jin[0].astype(jnp.bfloat16)
    want = torch.tensor(np.asarray(j_decode(*jin, n_heads=hk, interpret=True).astype(jnp.float32)))

    def rel(out):
        return float((out.float() - want).norm() / want.norm())

    assert rel(K3.decode_attention_int8_flat_plain(q, kq, ks, vq, vs, lengths, hk)) <= DECODE_ROUNDING_REL / 10
    assert rel(decode_f32_p(q, kq, ks, vq, vs, lengths, hk)) > DECODE_ROUNDING_REL


def test_causal_attention_routes_match_jax_xla():
    """ops/attention.py: "xla", "onepass" and "pallas" (each the plain path
    on a CPU tensor) all equal the reference's XLA path; an unknown impl
    raises."""
    from spatialrgpt_tpu_torch.ops.attention import causal_attention

    q, k, v = _qkv(np.random.default_rng(11), 2, 40, 4, 2, 16)
    seg = np.ones((2, 40), np.int32)
    seg[1, 25:] = 0
    want = np.asarray(j_causal(*_j(q, k, v), segment_ids=jnp.asarray(seg), impl="xla"))
    for impl in ("xla", "onepass", "pallas"):
        got = causal_attention(*_t(q, k, v), segment_ids=torch.tensor(seg), impl=impl).detach().numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)
    with pytest.raises(ValueError, match="unknown attention impl"):
        causal_attention(*_t(q, k, v), impl="ring")


# ---------------------------------------------------------------------------
# K4: plain forward / backward against the reference
# ---------------------------------------------------------------------------


def _packed_seg(B, S):
    """Row 0: two packed segments and a padded tail; row 1: one segment and
    a longer tail (blocks of 64 see mixed, uniform and all-padding ids)."""
    seg = np.zeros((B, S), np.int32)
    seg[0, :50] = 1
    seg[0, 50:110] = 2
    seg[1:, : S - 40] = 1
    return seg


def test_flash_plain_forward_matches_pallas():
    """out and lse of the plain forward against the Pallas ``_fwd`` in
    interpret mode, B2 S128 Hq8 Hk2 D32 with 64-blocks (atol 2e-5 / rtol
    2e-4, the JAX suite's own); padding rows have zero output and lse
    NEG_INF."""
    B, S, Hq, Hk, D = 2, 128, 8, 2, 32
    q, k, v = _qkv(np.random.default_rng(21), B, S, Hq, Hk, D)
    seg = _packed_seg(B, S)
    tr = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))  # noqa: E731
    jseg = jnp.asarray(seg)
    jout, jlse = jflash._fwd(tr(q), tr(k), tr(v), jseg, jseg, causal=True, sm_scale=D**-0.5,
                             block_q=64, block_k=64, interpret=True)
    out, lse = K4.flash_attention_fwd_plain(*_t(q, k, v), torch.tensor(seg))
    np.testing.assert_allclose(out.numpy(), np.transpose(np.asarray(jout), (0, 2, 1, 3)), atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-4)
    assert np.all(out.numpy()[seg == 0] == 0) and np.all(lse.numpy()[:, :, seg[0] == 0][0] == K4.NEG_INF)
    want = np.asarray(jflash.flash_attention(*_j(q, k, v), segment_ids=jseg, block_q=64, block_k=64, interpret=True))
    np.testing.assert_allclose(K4.flash_attention(*_t(q, k, v), torch.tensor(seg)).numpy(), want, atol=2e-5, rtol=2e-4)


def test_flash_plain_backward_matches_jax_grad():
    """dq, dk, dv through ``flash_attention`` (its Function runs the plain
    forward and backward on the CPU) against ``jax.grad`` of the reference's
    XLA causal attention, whose equality with the Pallas backward
    ``test_grads_match_xla`` holds; GQA 4:1, packed segments, padding.
    Padding rows get dq = 0 and add nothing to dk / dv."""
    B, S, Hq, Hk, D = 2, 128, 8, 2, 32
    q, k, v = _qkv(np.random.default_rng(22), B, S, Hq, Hk, D)
    seg = _packed_seg(B, S)

    def loss_xla(q, k, v):
        o = j_causal(q, k, v, segment_ids=jnp.asarray(seg), impl="xla")
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(loss_xla, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = K4.flash_attention(tq, tk, tv, torch.tensor(seg))
    (o * torch.cos(o)).sum().backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-5, rtol=5e-4, err_msg=f"d{name}")
    assert np.all(tq.grad.numpy()[seg == 0] == 0)
    # the plain backward called directly (dO of padding rows masked as the
    # wrapper's final multiply masks it) gives the same gradients
    seg_t = torch.tensor(seg)
    out, lse = K4.flash_attention_fwd_plain(*_t(q, k, v), seg_t)
    dout = (torch.cos(o) - o * torch.sin(o)).detach() * (seg_t != 0)[:, :, None, None]
    for got, want in zip(K4.flash_attention_bwd_plain(*_t(q, k, v), seg_t, out, lse, dout), (tq.grad, tk.grad, tv.grad)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert K4.launches == {"flash_attention_fwd": 0, "flash_attention_bwd_dkv": 0, "flash_attention_bwd_dq": 0}


@pytest.mark.parametrize("window", [16, 37])
def test_flash_plain_windowed_forward_matches_pallas(window):
    """The sliding window (key j live for query i only if i - j < window):
    out and lse of the plain forward against the Pallas ``_fwd`` with the
    same window in interpret mode, B2 S128 Hq8 Hk2 D32 with 64-blocks, where
    both windows cut inside each segment (50, 60 and 88 positions long) and
    37 straddles the 64-blocks' band edge (atol 2e-5 / rtol 2e-4, as the
    unwindowed test)."""
    B, S, Hq, Hk, D = 2, 128, 8, 2, 32
    q, k, v = _qkv(np.random.default_rng(23), B, S, Hq, Hk, D)
    seg = _packed_seg(B, S)
    tr = lambda a: jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))  # noqa: E731
    jseg = jnp.asarray(seg)
    jout, jlse = jflash._fwd(tr(q), tr(k), tr(v), jseg, jseg, causal=True, sm_scale=D**-0.5,
                             block_q=64, block_k=64, interpret=True, window=window)
    out, lse = K4.flash_attention_fwd_plain(*_t(q, k, v), torch.tensor(seg), window=window)
    np.testing.assert_allclose(out.numpy(), np.transpose(np.asarray(jout), (0, 2, 1, 3)), atol=2e-5, rtol=2e-4)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5, rtol=2e-4)
    # the window changes the answer: rows past it differ from the unwindowed ones
    full, _ = K4.flash_attention_fwd_plain(*_t(q, k, v), torch.tensor(seg))
    assert not torch.allclose(out[0, window + 5], full[0, window + 5])


def test_flash_windowed_backward_matches_jax_grad():
    """dq, dk, dv through ``flash_attention(..., window=37)`` (its Function
    runs the plain forward and backward on the CPU) against ``jax.grad`` of
    the reference's ``flash_attention(..., window=37)`` in interpret mode
    (the Pallas backward kernels), B2 S128 Hq8 Hk2 D32, 64-blocks; atol
    5e-5 / rtol 5e-4, as the unwindowed backward test."""
    B, S, Hq, Hk, D, window = 2, 128, 8, 2, 32, 37
    q, k, v = _qkv(np.random.default_rng(24), B, S, Hq, Hk, D)
    seg = _packed_seg(B, S)

    def loss_ref(q, k, v):
        o = jflash.flash_attention(q, k, v, segment_ids=jnp.asarray(seg), block_q=64, block_k=64, interpret=True,
                                   window=window)
        return jnp.sum(o * jnp.cos(o))

    want = jax.grad(loss_ref, argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    o = K4.flash_attention(tq, tk, tv, torch.tensor(seg), window=window)
    (o * torch.cos(o)).sum().backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-5, rtol=5e-4, err_msg=f"d{name}")
    assert np.all(tq.grad.numpy()[seg == 0] == 0)


def test_window_reaches_every_causal_attention_route():
    """ops/attention.py passes ``window`` to the "xla", "onepass" and
    "pallas" routes (each the plain path on a CPU tensor), as the
    reference's ``causal_attention`` does: all three equal its XLA path
    with the same window; a window below 1 raises on every K4 entry
    point."""
    from spatialrgpt_tpu_torch.ops.attention import causal_attention

    q, k, v = _qkv(np.random.default_rng(12), 2, 40, 4, 2, 16)
    seg = np.ones((2, 40), np.int32)
    seg[1, 25:] = 0
    want = np.asarray(j_causal(*_j(q, k, v), segment_ids=jnp.asarray(seg), impl="xla", window=9))
    for impl in ("xla", "onepass", "pallas"):
        got = causal_attention(*_t(q, k, v), segment_ids=torch.tensor(seg), impl=impl, window=9).detach().numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=1e-4)
    tq, tk, tv = _t(q, k, v)
    ts = torch.tensor(seg)
    lse, delta = torch.zeros(2, 4, 40), torch.zeros(2, 40, 4)
    for call in (lambda: K4.flash_attention(tq, tk, tv, ts, window=0),
                 lambda: K4.flash_attention_fwd(tq, tk, tv, ts, window=-3),
                 lambda: K4.flash_attention_bwd_dkv(tq, tk, tv, ts, lse, delta, tq, window=0),
                 lambda: K4.flash_attention_bwd_dq(tq, tk, tv, ts, lse, delta, tq, window=0)):
        with pytest.raises(ValueError, match="window"):
            call()


@pytest.mark.parametrize("kernel", ["vit_attention", "onepass_attention"])
def test_kernel_function_backward_matches_jax_grad(kernel):
    """K1 and K2 on the card run through ``KernelForwardPlainGrad``; here its
    forward is handed the plain version in the kernel's place, and its
    backward (recompute the plain version, differentiate it) is held against
    ``jax.grad`` of the Pallas function (interpret mode, XLA-recompute
    ``custom_vjp``)."""
    rng = np.random.default_rng(31)
    if kernel == "vit_attention":
        q, k, v = _qkv(rng, 2, 100, 2, 2, 72)
        plain = lambda q, k, v: K1.vit_attention_plain(q, k, v, 90)  # noqa: E731
        ref = lambda q, k, v: j_vit(q, k, v, interpret=True, valid_len=90)  # noqa: E731
    else:
        q, k, v = _qkv(rng, 2, 100, 4, 2, 32)
        seg = _packed_seg(2, 100)
        plain = lambda q, k, v: K2.onepass_attention_plain(q, k, v, torch.tensor(seg))  # noqa: E731
        ref = lambda q, k, v: j_onepass(q, k, v, segment_ids=jnp.asarray(seg), interpret=True)  # noqa: E731
    want = jax.grad(lambda q, k, v: jnp.sum(jnp.sin(ref(q, k, v))), argnums=(0, 1, 2))(*_j(q, k, v))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    torch.sin(KernelForwardPlainGrad.apply(plain, plain, tq, tk, tv)).sum().backward()
    for got, w, name in zip((tq.grad, tk.grad, tv.grad), want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-5, rtol=5e-4, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# the bound that holds each kernel against its plain version on the card
# ---------------------------------------------------------------------------


def _bf16(rng, *shape):
    return torch.tensor(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)


def _causal_gqa(q, k, v, seg, drop_rows=slice(0, 0), drop_keys=slice(0, 0)):
    """K2's function written out with a key mask: causal within a segment,
    and keys ``drop_keys`` left out for the query rows ``drop_rows``; GQA
    query head h reads kv head h // G."""
    S, D = q.shape[1], q.shape[3]
    g = q.shape[2] // k.shape[2]
    kk, vv = (t.float().repeat_interleave(g, dim=2) for t in (k, v))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kk) * D**-0.5
    i = torch.arange(S)
    ok = (seg[:, :, None] == seg[:, None, :]) & (seg[:, :, None] != 0) & (i[:, None] >= i[None, :])
    ok[:, drop_rows, drop_keys] = False
    p = torch.softmax(torch.where(ok[:, None], s, torch.full_like(s, -torch.inf)), dim=-1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), vv).to(torch.bfloat16)


@pytest.mark.parametrize(
    "kernel",
    [
        "vit_attention", "onepass_attention", "decode_attention_int8_flat",
        "flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq",
    ],
)
def test_bound_rejects_a_kernel_that_skips_a_key_tile(kernel):
    """``bf16_err_over_bound`` at the main path's head dims and lengths, in
    bf16: a kernel that left out the 64 keys [64, 128) (for K2 only in the
    query rows from 128 on, where ~200-300 keys are live) would exceed it.
    Such a kernel's output is the plain function with those keys masked.
    K1 and K3 mask them by moving them past ``valid_len`` / ``lengths``
    (attention is invariant to the order of its keys).  For K4 the fault
    is one 64-row tile left out of the forward, of dK/dV (a q tile) or of
    dQ (a key tile), at D = 128 with packed segments."""
    from spatialrgpt_tpu_torch.ops._checks import GRAD_FLOOR, bf16_err_over_bound

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
    elif kernel.startswith("flash"):
        # K4 at D = 128 and one packed row of 4 x 256-token samples with a
        # padded tail (the align step's 4 x ~1024, cut to keep the CPU short)
        S, Hq, Hk = 1088, 4, 1
        q, k, v, dout = _bf16(rng, 1, S, Hq, 128), _bf16(rng, 1, S, Hk, 128), _bf16(rng, 1, S, Hk, 128), _bf16(rng, 1, S, Hq, 128)
        seg = torch.zeros(1, S, dtype=torch.int32)
        for i in range(4):
            seg[0, 256 * i : 256 * (i + 1)] = i + 1
        out, lse = K4.flash_attention_fwd_plain(q, k, v, seg)
        delta = K4.attention_delta(out, dout)
        if kernel == "flash_attention_fwd":
            # the key tile [576, 640) left out for the queries after it
            ref = out
            fault = _causal_gqa(q, k, v, seg, drop_rows=slice(640, S), drop_keys=slice(576, 640))
            assert bf16_err_over_bound(_causal_gqa(q, k, v, seg), ref) <= 1.0
        else:
            # the q tile [576, 640) left out of dK/dV, or the key tile
            # [576, 640) left out of dQ: its P and dS are zeroed
            p, ds = K4._probs_and_ds(q, k, v, seg, lse, delta, dout)
            cut = (slice(None),) * 3 + ((slice(576, 640), slice(None)) if kernel.endswith("dkv") else (slice(None), slice(576, 640)))
            p_bad, ds_bad = p.clone(), ds.clone()
            p_bad[cut] = 0
            ds_bad[cut] = 0
            if kernel.endswith("dkv"):
                ref = torch.cat(K4.flash_attention_bwd_dkv_plain(q, k, v, seg, lse, delta, dout), dim=2)
                qg, dog = (t.reshape(1, S, Hk, Hq // Hk, 128).float() for t in (q, dout))
                dv = torch.einsum("bhgqk,bqhgd->bkhgd", p_bad.to(torch.bfloat16).float(), dog)
                dk = torch.einsum("bhgqk,bqhgd->bkhgd", ds_bad.to(torch.bfloat16).float(), qg)
                fault = torch.cat([K4._group_sum(dk, q.dtype), K4._group_sum(dv, q.dtype)], dim=2)
            else:
                ref = K4.flash_attention_bwd_dq_plain(q, k, v, seg, lse, delta, dout)
                dq = torch.einsum("bhgqk,bkhd->bqhgd", ds_bad.to(torch.bfloat16).float(), k.float())
                fault = dq.reshape(1, S, Hq, 128).to(torch.bfloat16)
    else:
        C, Hk = 352, 2
        q = _bf16(rng, 2, 8, 128)
        kq, ks, vq, vs = _t(*_int8_cache(rng, 2, C, Hk, 128))
        lengths = torch.tensor([330, 200], dtype=torch.int32)
        ref = K3.decode_attention_int8_flat_plain(q, kq, ks, vq, vs, lengths, Hk)
        order = list(range(64)) + list(range(128, C)) + tile
        kq, ks, vq, vs = (t[:, order] for t in (kq, ks, vq, vs))
        fault = K3.decode_attention_int8_flat_plain(q, kq, ks, vq, vs, lengths - 64, Hk)
    floor = GRAD_FLOOR if "_bwd_" in kernel else 0.0
    assert bf16_err_over_bound(ref, ref, floor) == 0.0
    assert bf16_err_over_bound(fault, ref, floor) > 1.0


# ---------------------------------------------------------------------------
# wrapper dispatch
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_without_a_launch(monkeypatch):
    for mod in (K1, K2, K3):
        monkeypatch.setattr(mod, "launches", 0)
    monkeypatch.setattr(K4, "launches", dict.fromkeys(K4.launches, 0))
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
    seg = torch.ones(1, 20, dtype=torch.int32)
    out, lse = K4.flash_attention_fwd(q, k, v, seg)
    want = K4.flash_attention_fwd_plain(q, k, v, seg)
    torch.testing.assert_close((out, lse), want, rtol=0, atol=0)
    delta = K4.attention_delta(out, q)
    torch.testing.assert_close(K4.flash_attention_bwd_dkv(q, k, v, seg, lse, delta, q),
                               K4.flash_attention_bwd_dkv_plain(q, k, v, seg, lse, delta, q), rtol=0, atol=0)
    torch.testing.assert_close(K4.flash_attention_bwd_dq(q, k, v, seg, lse, delta, q),
                               K4.flash_attention_bwd_dq_plain(q, k, v, seg, lse, delta, q), rtol=0, atol=0)
    assert set(K4.launches.values()) == {0}


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
    # one cluster of at most 8 CTAs per (row, kv head), each holding its
    # positions' scores for n_rep heads in shared memory: 16384 entries
    assert [K3.decode_cluster_size(c) for c in (1, 17, 256, 257, 352, 1000, 2048, 4096, 65536)] == [
        1, 1, 1, 2, 2, 4, 8, 8, 8]
    for C, n_rep, match in ((16384, 8, "CUDA"), (16385, 8, "scores"), (32768, 4, "CUDA"), (32769, 4, "scores")):
        cache = dict(k_q=_meta(1, C, D, dtype=torch.int8), k_s=_meta(1, C, 1, dtype=torch.float32),
                     v_q=_meta(1, C, D, dtype=torch.int8), v_s=_meta(1, C, 1, dtype=torch.float32))
        with pytest.raises(ValueError, match=match):
            K3.decode_attention_int8_flat(_meta(1, n_rep, D), **cache, lengths=_meta(1, dtype=torch.int32), n_heads=1)
    B, S, Hq, Hk, D = 1, 64, 8, 2, 128
    q, k, seg = _meta(B, S, Hq, D), _meta(B, S, Hk, D), _meta(B, S, dtype=torch.int32)
    with pytest.raises(TypeError):
        K4.flash_attention_fwd(q, k, k, _meta(B, S, dtype=torch.int64))
    with pytest.raises(ValueError, match="must divide 128"):
        K4.flash_attention_fwd(_meta(B, S, 3 * 128, D), _meta(B, S, 1, D), _meta(B, S, 1, D), seg)
    with pytest.raises(ValueError, match="at most 128|<= 128"):
        K4.flash_attention_fwd(_meta(B, S, Hq, 256), _meta(B, S, Hk, 256), _meta(B, S, Hk, 256), seg)
    with pytest.raises(ValueError, match="CUDA"):
        K4.flash_attention_fwd(q, k, k, seg)
    lse, delta = _meta(B, Hq, S, dtype=torch.float32), _meta(B, S, Hq, dtype=torch.float32)
    for fn in (K4.flash_attention_bwd_dkv, K4.flash_attention_bwd_dq):
        with pytest.raises(ValueError, match=r"\(1, 8, 64\)"):
            fn(q, k, k, seg, _meta(B, S, Hq, dtype=torch.float32), delta, q)
        with pytest.raises(TypeError):
            fn(q, k, k, seg, lse, delta, _meta(B, S, Hq, D, dtype=torch.float32))
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, k, seg, lse, delta, q.transpose(1, 2).contiguous().transpose(1, 2))
    # every K4 kernel lists at most 1024 tiles of 64 positions per CTA; only
    # the forward and dQ fold G = Hq / Hk heads into 128 rows, so dK/dV takes
    # a G that does not divide 128
    for S, match in ((K4.MAX_SEQ, "CUDA"), (K4.MAX_SEQ + 1, "most tiles")):
        q, k, seg = _meta(B, S, Hq, D), _meta(B, S, Hk, D), _meta(B, S, dtype=torch.int32)
        lse, delta = _meta(B, Hq, S, dtype=torch.float32), _meta(B, S, Hq, dtype=torch.float32)
        for fn in (K4.flash_attention_bwd_dkv, K4.flash_attention_bwd_dq):
            with pytest.raises(ValueError, match=match):
                fn(q, k, k, seg, lse, delta, q)
        with pytest.raises(ValueError, match=match):
            K4.flash_attention_fwd(q, k, k, seg)
    S = 64
    q, k, seg = _meta(B, S, 6, D), _meta(B, S, 2, D), _meta(B, S, dtype=torch.int32)
    lse, delta = _meta(B, 6, S, dtype=torch.float32), _meta(B, S, 6, dtype=torch.float32)
    with pytest.raises(ValueError, match="must divide 128"):
        K4.flash_attention_bwd_dq(q, k, k, seg, lse, delta, q)
    with pytest.raises(ValueError, match="CUDA"):
        K4.flash_attention_bwd_dkv(q, k, k, seg, lse, delta, q)


@pytest.mark.parametrize(
    "hq,hk,D,match",
    [
        (6, 4, 64, "dividing 128"),  # Hq / Hk not an integer
        (12, 4, 64, "dividing 128"),  # G = 3
        (256, 1, 64, "dividing 128"),  # G = 256: more heads than the CTA's 128 rows
        (4, 2, 256, "<= 128"),
        (4, 2, 12, "multiple of 8"),
        (4, 2, 128, "CUDA"),
        (32, 8, 128, "CUDA"),  # llama3-8b
        (128, 1, 128, "CUDA"),  # G = 128: one position per CTA
    ],
)
def test_onepass_wrapper_follows_the_fold_rule(hq, hk, D, match):
    """K2 folds G = Hq / Hk query heads x 128 / G positions into one CTA's
    128 rows on the Hopper main loop (head dim <= 128, a multiple of 8): a
    G that does not divide 128 raises before any pointer reaches C, and a
    call that the kernel takes fails on meta tensors only for not being on
    a CUDA card."""
    with pytest.raises(ValueError, match=match):
        K2.onepass_attention(_meta(1, 8, hq, D), _meta(1, 8, hk, D), _meta(1, 8, hk, D))


def test_hopper_wrappers_reject_wide_heads_and_grids():
    """K1 and K5 run on the Hopper main loop (head dims up to 80, K5's bias
    rows for grids up to 64 per side in shared memory): wider raises
    before any pointer reaches C; the widest that fits fails only for not
    being on a CUDA card."""
    with pytest.raises(ValueError, match="head dim 96 > 80"):
        K1.vit_attention(*(_meta(1, 8, 2, 96),) * 3)
    with pytest.raises(ValueError, match="CUDA"):
        K1.vit_attention(*(_meta(1, 8, 2, 80),) * 3)
    for (gh, gw, D), match in (((2, 65, 64), "at most 64"), ((65, 2, 64), "at most 64"),
                               ((8, 8, 96), "head dim 96 > 80"), ((64, 64, 80), "CUDA")):
        S, H = gh * gw, 2
        qkv = [_meta(1, S, H, D) for _ in range(3)]
        rel_h, rel_w = _meta(1, H, S, gh, dtype=torch.float32), _meta(1, H, S, gw, dtype=torch.float32)
        with pytest.raises(ValueError, match=match):
            K4.grid_bias_attention(*qkv, rel_h, rel_w, gw)
