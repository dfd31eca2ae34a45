"""Port parity for training on a quantized base: the gradients of
``linear``'s quantized branches (the W8A8 straight-through backward, its
int8 route on K10 + K11, the int8 weight-only dx), gradient flow through
siblings that share x's int8 rows, and one step of the frozen-base and the
LoRA train steps, against the JAX package on the same numpy inputs, in
fp32 on the CPU (the port's K7-K11 wrappers take their plain versions).

Tolerances:
- the bf16 STE dx: both sides round dy and the dequantized weight to bf16
  and sum the exact products in f32, in another order: 1e-5 relative;
- the int8 backward: K10's plain version is bit-equal to the reference's
  dyq and gscale, K11's int32 sums are exact, and the epilogue is the
  reference's: dx equal bit for bit;
- the weight-only dx: f32 operands on both sides, another summation order:
  1e-5;
- the train steps: the forward quantizes activations to int8 in every
  layer, so an f32 difference of one ulp in a layer's input (the decoder's
  other summation order) can move one int8 step of a row (1/127 of its
  largest value), and the backward rounds dy to bf16 (the STE) or to int8
  (K10) in every projection, where one ulp can flip a rounding of 2^-9 or
  1/254 of the element; the flips add up over the 2 layers x 7
  projections that the tuned modules' gradients pass.  Loss 1e-4
  relative; gradients 1e-2 relative to the tensor's largest value (a
  wrong scale, layout or missing branch moves them by O(1)); the updated
  parameters the same where the gradient lies clear of that tolerance
  around 0, else within 2 lr (Adam's first update is about lr * sign(g),
  ``_close_update``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.ops import layers as jlayers
from spatialrgpt_tpu.ops import quant as jquant
from spatialrgpt_tpu.train import lora as jlora
from spatialrgpt_tpu.train import optimizer as jopt
from spatialrgpt_tpu.train import step as jstep
from spatialrgpt_tpu.utils import export
from spatialrgpt_tpu_torch.ops import int8_linear
from spatialrgpt_tpu_torch.ops import layers as tlayers
from spatialrgpt_tpu_torch.train import lora as tlora
from spatialrgpt_tpu_torch.train import optimizer as topt
from spatialrgpt_tpu_torch.train import step as tstep
from spatialrgpt_tpu_torch.utils.weights import load_adapters_from_jax, load_from_jax
from tests.test_torch_train import TINY, TINY_T, _batch, _np_tree


@pytest.fixture
def int8_backward():
    """Both packages' int8-backward switch on inside the test."""
    jlayers.enable_int8_backward(True)
    tlayers.enable_int8_backward(True)
    try:
        yield
    finally:
        jlayers.enable_int8_backward(False)
        tlayers.enable_int8_backward(False)


def _quant_linear(w, act_quant, bias=None):
    """The reference's ``kernel_q`` entry of a (din, dout) kernel and the
    port's ``QuantLinear`` of the same weight."""
    p = {"kernel_q": jquant.quantize_int8(jnp.asarray(w), act_quant=act_quant)}
    lin = nn.Linear(*w.shape, bias=bias is not None)
    with torch.no_grad():
        lin.weight.copy_(torch.tensor(w.T))
        if bias is not None:
            p["bias"] = jnp.asarray(bias)
            lin.bias.copy_(torch.tensor(bias))
    return p, tlayers.QuantLinear.from_linear(lin, 8, act_quant)


def _dx_pair(x, co, p, ql, dtype=np.float32):
    """dx of sum(linear(x) * co) in both packages, x in ``dtype``; the
    reference's under jit, as its train steps run it (XLA then folds the
    division by 127 into a multiply, which the port's K10 does too)."""
    jdt, tdt = (jnp.float32, torch.float32) if dtype == np.float32 else (jnp.bfloat16, torch.bfloat16)
    grad = jax.jit(jax.grad(lambda x, p, co: (jlayers.linear(x, p).astype(jnp.float32) * co).sum()))
    want = grad(jnp.asarray(x, jdt), p, jnp.asarray(co))
    xt = torch.tensor(x).to(tdt).requires_grad_(True)
    (tlayers.linear(xt, ql).float() * torch.tensor(co)).sum().backward()
    return np.asarray(want.astype(jnp.float32)), xt.grad.float().numpy()


# (x shape, din, dout, W8A8 expected): an expanding weight at a few rows,
# a contracting one at A8_MIN_ROWS rows (the reference's gate, layers.py:114-120)
_STE_CASES = {"expanding": ((2, 3, 32), 32, 48), "contracting_2048_rows": ((2, 1024, 48), 48, 32)}


@pytest.mark.parametrize("case", sorted(_STE_CASES))
def test_w8a8_ste_dx_matches_jax(case):
    """The default straight-through backward: dx = bf16(dy) @ bf16(q *
    scale) with f32 sums (``layers.py:79-86``), equal to ``jax.grad`` of
    the reference's ``linear`` (with a bias: it gets no gradient)."""
    shape, din, dout = _STE_CASES[case]
    rng = np.random.default_rng(din)
    w = rng.standard_normal((din, dout)).astype(np.float32)
    p, ql = _quant_linear(w, True, rng.standard_normal(dout).astype(np.float32))
    assert ql.takes_a8(int(np.prod(shape[:-1])))
    x = rng.standard_normal(shape).astype(np.float32)
    co = rng.standard_normal(shape[:-1] + (dout,)).astype(np.float32)
    want, got = _dx_pair(x, co, p, ql)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    assert ql.bias.grad is None


def _reference_dy_quant(dy, scale):
    """The reference's SwitchBack prologue, ``_w8a8_dot_bwd``'s int8 route
    (spatialrgpt_tpu/ops/layers.py:70-73), which the JAX package keeps
    inside the backward."""
    dyf = dy.astype(jnp.float32) * scale.astype(jnp.float32)
    gmax = jnp.max(jnp.abs(dyf), axis=-1, keepdims=True)
    gscale = jnp.maximum(gmax / 127.0, 1e-30)
    dyq = jnp.clip(jnp.round(dyf / gscale), -127, 127).astype(jnp.int8)
    return dyq, gscale[..., 0]


def test_k10_plain_equals_the_reference():
    """K10's plain version: dyq and gscale equal to the reference's (under
    jit: the compiled HLO multiplies the max by f32(1/127)) on random rows,
    a row of zeros (gscale 1e-30), a row of ties and rows of a large and a
    tiny magnitude."""
    rng = np.random.default_rng(3)
    dy = rng.standard_normal((8, 48)).astype(np.float32)
    scale = (rng.random(48) * 1e-2 + 1e-4).astype(np.float32)
    dy[1] = 0.0
    dy[2] = (rng.integers(-126, 127, 48) + 0.5) / scale
    dy[3] *= 1e5
    dy[4] *= 1e-20
    want_q, want_s = jax.jit(_reference_dy_quant)(jnp.asarray(dy), jnp.asarray(scale))
    got_q, got_s = int8_linear.act_quant_dy_int8(torch.tensor(dy), torch.tensor(scale))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert float(got_s[1]) == np.float32(1e-30) and not got_q[1].any()


@pytest.mark.parametrize("N", [48, 40])
def test_k10_wrapper_on_the_cpu_returns_contiguous_rows(N):
    """On the CPU K10's wrapper returns contiguous (M, N) rows, at N % 16 ==
    0 and at N % 16 == 8 (on the card they lie N rounded up to 16 apart)."""
    rng = np.random.default_rng(N)
    dy = torch.tensor(rng.standard_normal((5, N)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.tensor((rng.random(N) * 1e-2 + 1e-4).astype(np.float32))
    dyq, gscale = int8_linear.act_quant_dy_int8(dy, scale)
    assert dyq.shape == (5, N) and dyq.is_contiguous() and dyq.dtype == torch.int8 and gscale.shape == (5,)


# ragged M, N % 16 == 8 (the lm_head's 128,264), K % 128 != 0
@pytest.mark.parametrize("M,N,K", [(37, 1032, 4304), (129, 8, 80), (300, 4104, 1040)])
def test_k11_is_k8s_product_on_the_transposed_weight(M, N, K):
    """K11's premise: its plain version equals K8's plain version over dyq
    with gscale as the row scale, the transposed weight and a column scale
    of ones, bit for bit (``__fmul_rn(gscale, 1.0f)`` is gscale)."""
    rng = np.random.default_rng(M + N + K)
    dyq = torch.tensor(rng.integers(-127, 128, (M, N)), dtype=torch.int8)
    q = torch.tensor(rng.integers(-127, 128, (N, K)), dtype=torch.int8)
    gscale = torch.tensor(rng.random(M) * 1e-4 + 1e-6, dtype=torch.float32)
    want = int8_linear.int8_dx_gemm_plain(dyq, q, gscale)
    got = int8_linear.w8a8_gemm_plain(dyq, gscale, q.t().contiguous(), torch.ones(K))
    assert got.dtype == want.dtype == torch.bfloat16 and torch.equal(got, want)


def test_k11_wrapper_refuses_strided_columns():
    """K11 takes dyq's rows at any 16-byte stride (K10's padded rows) but
    not columns that are not contiguous; checked before the device."""
    dyq = torch.empty(64, 4, dtype=torch.int8, device="meta").t()
    q = torch.empty(64, 32, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="contiguous rows"):
        int8_linear.int8_dx_gemm(dyq, q, torch.empty(4, device="meta"))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(_STE_CASES))
def test_int8_backward_matches_jax(int8_backward, case, dtype):
    """Under ``enable_int8_backward`` both packages run dx as K10 then K11
    (their plain versions here): dx equal bit for bit after the cast to x's
    dtype, for f32 and bf16 x."""
    shape, din, dout = _STE_CASES[case]
    rng = np.random.default_rng(din + 1)
    w = rng.standard_normal((din, dout)).astype(np.float32)
    p, ql = _quant_linear(w, True)
    x = rng.standard_normal(shape).astype(np.float32)
    co = rng.standard_normal(shape[:-1] + (dout,)).astype(np.float32)
    want, got = _dx_pair(x, co, p, ql, dtype)
    np.testing.assert_array_equal(got, want)


def test_int8_backward_switch_is_read_at_the_forward():
    """The switch acts on the forwards that run after it: a graph built
    with it off keeps the bf16 STE even if it is turned on before the
    backward."""
    rng = np.random.default_rng(0)
    _, ql = _quant_linear(rng.standard_normal((32, 48)).astype(np.float32), True)
    x = torch.tensor(rng.standard_normal((4, 32)).astype(np.float32))
    co = torch.tensor(rng.standard_normal((4, 48)).astype(np.float32))

    def dx(flip_before_backward):
        xt = x.clone().requires_grad_(True)
        loss = (tlayers.linear(xt, ql) * co).sum()
        tlayers.enable_int8_backward(flip_before_backward)
        try:
            loss.backward()
        finally:
            tlayers.enable_int8_backward(False)
        return xt.grad

    ste = tlayers._ste_dx(co, ql, torch.float32, int8=False, kernels=False)
    torch.testing.assert_close(dx(True), ste, rtol=0, atol=0)
    torch.testing.assert_close(dx(False), ste, rtol=0, atol=0)


@pytest.mark.parametrize("shape", [(3, 5, 32), (7, 32)])
def test_weight_only_dx_matches_jax(shape):
    """The int8 weight-only branch: dx of autodiff through ``(x @ q) *
    scale``, ``(f32(dy) * scale) @ q`` in f32 (the reference's jaxpr),
    equal to ``jax.grad``; contracting and expanding weights alike."""
    rng = np.random.default_rng(len(shape))
    for din, dout in ((32, 48), (32, 20)):
        w = rng.standard_normal((din, dout)).astype(np.float32)
        p, ql = _quant_linear(w, False, rng.standard_normal(dout).astype(np.float32))
        x = rng.standard_normal(shape[:-1] + (din,)).astype(np.float32)
        co = rng.standard_normal(shape[:-1] + (dout,)).astype(np.float32)
        want, got = _dx_pair(x, co, p, ql)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


class _Attn(nn.Module):
    def __init__(self, mods):
        super().__init__()
        self.q_proj, self.k_proj, self.v_proj = mods


@pytest.mark.parametrize("rows", [(2, 3), (2, 1024)], ids=["expanding_only", "all_w8a8"])
def test_shared_xq_siblings_carry_dx(rows):
    """q/k/v read one set of x's int8 rows (``quantized_input``); each
    sibling's dx still reaches x: dx equals ``jax.grad`` of the reference's
    ``qkv_proj`` (k / v contract: weight-only below 2048 rows)."""
    rng = np.random.default_rng(rows[1])
    hq, hk, d = 4, 2, 8
    C = hq * d
    ws = [rng.standard_normal((C, n * d)).astype(np.float32) for n in (hq, hk, hk)]
    pairs = [_quant_linear(w, True) for w in ws]
    jp = {name: pr[0] for name, pr in zip(("wq", "wk", "wv"), pairs)}
    x = rng.standard_normal(rows + (C,)).astype(np.float32)
    cos = [rng.standard_normal(rows + (n, d)).astype(np.float32) for n in (hq, hk, hk)]

    def jloss(x):
        return sum((o * c).sum() for o, c in zip(jlayers.qkv_proj(x, jp, hq, hk, d), cos))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    outs = tlayers.qkv_proj(xt, _Attn([pr[1] for pr in pairs]), hq, hk, d)
    sum((o * torch.tensor(c)).sum() for o, c in zip(outs, cos)).backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------------------
# the train steps against the reference's
# ---------------------------------------------------------------------------

OCFG_ALIGN = dict(learning_rate=1e-3, tune_language_model=False, tune_vision_tower=False, tune_mm_projector=True,
                  tune_region_extractor=True, total_steps=10, warmup_ratio=0.0)


@pytest.fixture(scope="module")
def params():
    return jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(1), TINY)


def _hf(label, tree):
    """A projector / region subtree (params or grads) under the port's
    parameter names."""
    if label == "projector":
        return {"mm_projector." + k: v for k, v in export.export_projector(_np_tree(tree)).items()}
    return {"region_extractor." + k: v for k, v in export.export_region_extractor(_np_tree(tree)).items()}


# gradients and updates of the train steps, relative to the largest value
STEP_REL = 1e-2


def _close(got: torch.Tensor, want, name, rel=STEP_REL):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=rel, atol=rel * max(np.abs(want).max(), 1e-12),
                               err_msg=name)


def _close_update(got: torch.Tensor, want, grad, lr, name, rel=STEP_REL):
    """An updated parameter after Adam's first step, whose update is
    lr * g / (|g| + eps), about lr * sign(g): equal (to ``rel`` of the
    largest value) where the reference's gradient lies clear of its own
    tolerance around 0, and at most 2 lr apart where it does not (there the
    two packages' gradients may differ in sign)."""
    want, grad = np.asarray(want, np.float32), np.abs(np.asarray(grad, np.float32))
    clear = grad > 4 * rel * grad.max()
    diff = np.abs(got.detach().float().numpy() - want)
    bound = np.where(clear, rel * np.abs(want).max(), 2 * lr * (1 + rel))
    assert (diff <= bound).all(), f"{name}: {int((diff > bound).sum())} of {diff.size} off, max {diff.max()}"


@pytest.mark.parametrize("int8_bwd", [False, True], ids=["ste_bf16", "int8_backward"])
def test_frozen_base_train_step_matches_jax(params, int8_bwd):
    """One step of ``make_frozen_base_train_step`` with a W8A8 decoder and
    tower (bench_train.py's SRGPT_TRAIN_BENCH_QUANT=1 and =2): loss,
    num_tokens and grad_norm, the projector's and region extractor's
    gradients and their updated weights against the reference's step (its
    gradients from ``jax.grad`` of the same loss)."""
    inputs, jin = _batch(5)
    base = dict(params, llm=jquant.quantize_llm(params["llm"], act_quant=True),
                vision=jquant.quantize_llm(params["vision"], act_quant=True))
    trainable = {"projector": base.pop("projector"), "region": base.pop("region")}
    jlayers.enable_int8_backward(int8_bwd)
    tlayers.enable_int8_backward(int8_bwd)
    try:
        jtx = jopt.build_optimizer(trainable, jopt.OptimizerConfig(**OCFG_ALIGN))
        jstate = jstep.create_train_state(trainable, jtx)
        jstate2, jm = jstep.make_frozen_base_train_step(TINY, jtx, donate=False)(jstate, base, jin)
        jgrads = jax.grad(lambda t: jvlm.loss_fn({**jax.lax.stop_gradient(base), **t}, TINY, jin)[0])(trainable)

        model = load_from_jax(_np_tree({**base, **trainable}), TINY_T, "cpu")
        tx = topt.build_optimizer(model, topt.OptimizerConfig(**OCFG_ALIGN))
        state = tstep.create_train_state(model, tx)
        _, m = tstep.make_frozen_base_train_step(TINY_T, tx)(state, inputs)
    finally:
        jlayers.enable_int8_backward(False)
        tlayers.enable_int8_backward(False)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    assert int(m["num_tokens"]) == int(jm["num_tokens"])
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    _check_modules(model, jgrads, jstate2.params, OCFG_ALIGN["learning_rate"])
    assert all(p.grad is None for p in model.llm.parameters())


def _check_modules(model, jgrads, jparams, lr):
    """The projector's and region extractor's gradients and updated weights."""
    named = dict(model.named_parameters())
    for label in ("projector", "region"):
        grads = _hf(label, jgrads[label])
        for name, want in grads.items():
            _close(named[name].grad, want, "grad " + name)
        for name, want in _hf(label, jparams[label]).items():
            _close_update(named[name], want, grads[name], lr, "param " + name)


@pytest.mark.parametrize("use_dora", [False, True], ids=["side_branch", "dora_merged"])
def test_lora_train_step_matches_jax(params, use_dora):
    """One step of ``make_lora_train_step`` on an int8 weight-only decoder
    (QLoRA, bench_train.py's qlora stage: adapters on the seven
    projections, projector and region extractor co-trained at the default
    config's lr): loss, gradients of every adapter and of the co-trained
    modules, and their updated values, against the reference's step.  The
    adapters start from the reference's ``init_lora`` with b moved off 0,
    so that every factor has a gradient."""
    inputs, jin = _batch(6)
    lcfg = dict(r=4, alpha=8.0, use_dora=use_dora)
    base = dict(params, llm=jquant.quantize_llm(params["llm"], bits=8))
    adapters = jlora.init_lora(jax.random.PRNGKey(2), base["llm"], jlora.LoraConfig(**lcfg))
    adapters = jax.tree.map(lambda t: t + 0.02, adapters)
    trainable = {"adapters": adapters, "projector": base.pop("projector"), "region": base.pop("region")}
    ocfg = dict(learning_rate=5e-3, total_steps=10, warmup_ratio=0.0)
    jtx = jopt.build_optimizer(trainable, jopt.OptimizerConfig(**ocfg))
    step = jstep.make_lora_train_step(TINY, jtx, jlora.LoraConfig(**lcfg), donate=False)
    jstate2, jm = step(jstep.create_train_state(trainable, jtx), base, jin)

    def jloss(t):
        p = {**jax.lax.stop_gradient(base), **{k: v for k, v in t.items() if k != "adapters"}}
        p["llm"] = jlora.apply_lora(base["llm"], t["adapters"], jlora.LoraConfig(**lcfg), merge=use_dora)
        return jvlm.loss_fn(p, TINY, jin)[0]

    jgrads = jax.grad(jloss)(trainable)

    model = load_from_jax(_np_tree(dict(base, projector=trainable["projector"], region=trainable["region"])), TINY_T,
                          "cpu")
    model.adapters = load_adapters_from_jax(_np_tree(adapters), "cpu")
    holder = nn.ModuleDict({"adapters": model.adapters, "mm_projector": model.mm_projector,
                            "region_extractor": model.region_extractor})
    tx = topt.build_optimizer(holder, topt.OptimizerConfig(**ocfg))
    assert [g["label"] for g in tx.param_groups] == ["projector", "region", "adapters"]
    _, m = tstep.make_lora_train_step(TINY_T, tx, tlora.LoraConfig(**lcfg))(tstep.create_train_state(model, tx),
                                                                          inputs)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-3)
    _check_modules(model, jgrads, jstate2.params, ocfg["learning_rate"])
    got = load_adapters_from_jax(_np_tree(jstate2.params["adapters"]), "cpu")
    grads = load_adapters_from_jax(_np_tree(jgrads["adapters"]), "cpu")
    for (name, pair), (_, new), (_, g) in zip(model.adapters.items(), got.items(), grads.items()):
        for leaf in ("a", "b", "m") if use_dora else ("a", "b"):
            want_g = getattr(g, leaf).detach()
            _close(getattr(pair, leaf).grad, want_g, f"grad {name}.{leaf}")
            _close_update(getattr(pair, leaf), getattr(new, leaf).detach(), want_g, ocfg["learning_rate"],
                          f"param {name}.{leaf}")
    assert all(p.grad is None for p in model.llm.parameters())


# ---------------------------------------------------------------------------
# the reference's own tests of this path, on the port
# ---------------------------------------------------------------------------


def test_frozen_base_train_step_runs_and_updates(params):
    """The port of tests/test_misc.py::test_frozen_base_train_step_runs_and_updates:
    one step over a W8A8 decoder: loss finite, the trainable modules move,
    the frozen int8 base is untouched."""
    inputs, _ = _batch(7)
    model = load_from_jax(_np_tree(dict(params, llm=jquant.quantize_llm(params["llm"], act_quant=True))), TINY_T,
                          "cpu")
    tx = topt.build_optimizer(model, topt.OptimizerConfig(**OCFG_ALIGN))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = tstep.create_train_state(model, tx)
    _, metrics = tstep.make_frozen_base_train_step(TINY_T, tx)(state, inputs)
    assert np.isfinite(float(metrics["loss"]))
    after = model.state_dict()
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved and all(k.startswith(("mm_projector.", "region_extractor.")) for k in moved)
    # a quantized module's float bias cannot be trained (SigLIP's projections have one)
    tower = load_from_jax(_np_tree(dict(params, vision=jquant.quantize_llm(params["vision"], act_quant=True))),
                          TINY_T, "cpu")
    with pytest.raises(ValueError, match="quantized"):
        tstep.create_train_state(tower, topt.build_optimizer(tower, topt.OptimizerConfig(
            **dict(OCFG_ALIGN, tune_vision_tower=True))))


def test_w8a8_int8_backward_gradient_close_to_oracle(int8_backward):
    """The port of tests/test_misc.py::test_w8a8_int8_backward_gradient_close_to_oracle:
    the int8 dx stays within quantization tolerance of the dequantized
    weight's gradient (per-token dy quantization noise ~1/127 relative)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((48, 80)).astype(np.float32)
    _, ql = _quant_linear(w, True)
    x = torch.tensor(rng.standard_normal((6, 48))).to(torch.bfloat16).requires_grad_(True)
    co = torch.tensor(rng.standard_normal((6, 80)).astype(np.float32))
    (tlayers.linear(x, ql).float() * co).sum().backward()
    wd = ql.dequantized(torch.bfloat16).float()
    b = (co @ wd).double().numpy()
    a = x.grad.double().numpy()
    assert np.abs(a - b).max() / max(np.abs(b).max(), 1e-9) < 0.03
    assert float(a.ravel() @ b.ravel() / (np.linalg.norm(a) * np.linalg.norm(b))) > 0.999
