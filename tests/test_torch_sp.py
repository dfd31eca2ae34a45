"""Port parity for sequence parallelism (``spatialrgpt_tpu_torch/parallel/
{ring,ulysses,hybrid}.py`` and the sequence-parallel prefill of
``serving/generate.py``) on gloo ranks.

The inputs are made with numpy from seeds (``tests/test_sequence_parallel.py``'s
``_data``: GQA 8 q / 4 kv heads, two packed segments in row 0, 8 padding
positions in row 1).  One group of ranks per world size (2, 4, 8) runs
every case of this file at that size once (``torch_parallel_cases``); each
case is its own test.  Every sequence-parallel function is held, forward
and gradients of sum(out**2), at f32 with atol 1e-5 and rtol 1e-4, to the
JAX package's global ``causal_attention`` at every degree, and at one
degree each to the JAX function itself under ``shard_map`` on the 8-device
CPU mesh.  The prefill routes give the JAX ``generate``'s greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_parallel_cases as cases
from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.ops.attention import causal_attention
from spatialrgpt_tpu.parallel import ring as jring
from spatialrgpt_tpu.parallel.hybrid import hybrid_attention
from spatialrgpt_tpu.parallel.ulysses import ulysses_attention
from spatialrgpt_tpu.serving.generate import generate as jgenerate

TOL = dict(atol=1e-5, rtol=1e-4)
# the one-shot JAX references compile at XLA optimisation level 0 (their
# unrolled ring loops take minutes to optimise on the CPU)
QUICK_XLA = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
MAX_NEW = 4


def _data(seed=0, B=2, S=64, Hq=8, Hk=4, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hk, D)).astype(np.float32)
    seg = np.ones((B, S), np.int32)
    seg[0, S // 2 :] = 2
    seg[1, -8:] = 0
    return q, k, v, seg


DATA = _data()
CFG = cases.tiny_cfg(jconfig)
ARRAYS = cases.tiny_batch_arrays(cases.tiny_cfg())


@pytest.fixture(scope="module")
def params():
    return jax.tree.map(np.asarray, jax.jit(jvlm.init_params, static_argnums=1)(jax.random.PRNGKey(2), CFG))


def _att(kind, **kw):
    q, k, v, seg = DATA
    return ("sp_attention", dict(kind=kind, q=q, k=k, v=v, seg=seg, **kw))


def _serve(impl, **kw):
    return ("sp_generate", dict(cfg=cases.tiny_cfg(), arrays=ARRAYS, max_new=MAX_NEW, impl=impl, **kw))


# world -> {case name: (function, kwargs)}; the params are added at spawn time
GROUPS = {
    2: {"ring": _att("ring"), "stripe": _att("stripe"), "zigzag": _att("zigzag"), "ulysses": _att("ulysses"),
        "serve_ulysses": _serve("ulysses"),
        "ulysses_bad_heads": ("ulysses_bad_heads", dict(q=DATA[0][:, :32, :3], k=DATA[1][:, :32, :1],
                                                        v=DATA[2][:, :32, :1], seg=DATA[3][:, :32]))},
    4: {"ring": _att("ring"), "stripe": _att("stripe"), "zigzag": _att("zigzag"), "ulysses": _att("ulysses"),
        "hybrid": _att("hybrid", ulysses=2), "serve_ring": _serve("ring"), "serve_hybrid": _serve("hybrid", ulysses=2)},
    8: {"ring": _att("ring"), "stripe": _att("stripe")},
}


@pytest.fixture(scope="module")
def groups(params, tmp_path_factory):
    """world -> rank -> {case: result}: one group of ranks per world size."""
    out = {}
    for world, group in GROUPS.items():
        calls = []
        for name, (fn, kw) in group.items():
            if fn == "sp_generate":
                kw = dict(kw, params=params)
            calls.append((name, fn, kw))
        out[world] = cases.spawn(world, calls, tmp_path_factory.mktemp(f"sp{world}"))
    return out


def _case(groups, world, name):
    results = [r[name] for r in groups[world]]
    for r in results:
        assert not (isinstance(r, dict) and "error" in r), r["error"]
    return results


def _assemble(results, shape_like):
    """The ranks' (positions, out, dq, dk, dv) -> global (out, dq, dk, dv)."""
    out = [np.zeros_like(a) for a in shape_like]
    for held, *parts in results:
        for dst, part in zip(out, parts):
            dst[:, held] = part
    return out


@pytest.fixture(scope="module")
def global_ref():
    """The JAX global attention's output and gradients of sum(out**2)."""
    q, k, v, seg = (jnp.asarray(a) for a in DATA)

    def loss(q, k, v):
        return jnp.sum(jnp.square(causal_attention(q, k, v, segment_ids=seg)))

    out = causal_attention(q, k, v, segment_ids=seg)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)), compiler_options=QUICK_XLA)(q, k, v)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _check(got, want):
    for a, b, n in zip(got, want, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, err_msg=n, **TOL)


def _shape_like():
    q, k, v, _ = DATA
    return [q, q, k, v]


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_ring_matches_global(groups, global_ref, sp):
    _check(_assemble(_case(groups, sp, "ring"), _shape_like()), global_ref)


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_stripe_ring_matches_global(groups, global_ref, sp):
    _check(_assemble(_case(groups, sp, "stripe"), _shape_like()), global_ref)


@pytest.mark.parametrize("sp", [2, 4])
def test_zigzag_ring_matches_global(groups, global_ref, sp):
    _check(_assemble(_case(groups, sp, "zigzag"), _shape_like()), global_ref)


@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_matches_global(groups, global_ref, sp):
    _check(_assemble(_case(groups, sp, "ulysses"), _shape_like()), global_ref)


def test_hybrid_matches_global(groups, global_ref):
    """Ulysses 2 x ring 2, the sequence ring-major."""
    _check(_assemble(_case(groups, 4, "hybrid"), _shape_like()), global_ref)


def test_ulysses_degree_must_divide_heads(groups):
    for msg in _case(groups, 2, "ulysses_bad_heads"):
        assert "must divide both head counts" in msg


# ---------------------------------------------------------------------------
# against the JAX functions themselves under shard_map (degree 4)
# ---------------------------------------------------------------------------


def _jax_sharded(fn, perm=None, axes="sp", mesh=None):
    """Output and gradients of sum(out**2) of ``fn`` under shard_map over a
    4-device mesh, the inputs laid out by ``perm`` and the result put back
    in global order."""
    q, k, v, seg = (jnp.asarray(a) for a in DATA)
    S = q.shape[1]
    perm = np.arange(S) if perm is None else perm
    inv = np.argsort(perm)
    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()[:4]), ("sp",))
    spec = P(None, axes)
    sharded = shard_map(fn, mesh=mesh, in_specs=(spec,) * 4, out_specs=spec)

    def run(q, k, v):
        return sharded(q[:, perm], k[:, perm], v[:, perm], seg[:, perm])[:, inv]

    grad = jax.grad(lambda q, k, v: jnp.sum(jnp.square(run(q, k, v))), argnums=(0, 1, 2))
    grads = jax.jit(grad, compiler_options=QUICK_XLA)(q, k, v)
    return [np.asarray(jax.jit(run, compiler_options=QUICK_XLA)(q, k, v))] + [np.asarray(g) for g in grads]


def test_ring_matches_jax_shard_map(groups):
    want = _jax_sharded(lambda q, k, v, s: jring.ring_attention(q, k, v, s, axis_name="sp"))
    _check(_assemble(_case(groups, 4, "ring"), _shape_like()), want)


def test_stripe_matches_jax_shard_map(groups):
    want = _jax_sharded(lambda q, k, v, s: jring.stripe_ring_attention(q, k, v, s, axis_name="sp"),
                        perm=jring.stripe_permutation(64, 4)[0])
    _check(_assemble(_case(groups, 4, "stripe"), _shape_like()), want)


def test_zigzag_matches_jax_shard_map(groups):
    want = _jax_sharded(lambda q, k, v, s: jring.zigzag_ring_attention(q, k, v, s, axis_name="sp"),
                        perm=jring.zigzag_permutation(64, 4)[0])
    _check(_assemble(_case(groups, 4, "zigzag"), _shape_like()), want)


def test_ulysses_matches_jax_shard_map(groups):
    """The JAX twin's forward (its all-to-alls are linear: JAX derives the
    backward) and gradients."""
    want = _jax_sharded(lambda q, k, v, s: ulysses_attention(q, k, v, s, axis_name="sp"))
    _check(_assemble(_case(groups, 4, "ulysses"), _shape_like()), want)


def test_hybrid_matches_jax_shard_map(groups):
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("sp_u", "sp_r"))
    want = _jax_sharded(lambda q, k, v, s: hybrid_attention(q, k, v, s), axes=("sp_r", "sp_u"), mesh=mesh)
    _check(_assemble(_case(groups, 4, "hybrid"), _shape_like()), want)


# ---------------------------------------------------------------------------
# the sequence-parallel serving prefill
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_tokens(params):
    sb, img, dep, masks, valid = ARRAYS
    batch = to_vlm_inputs(sb, img, dep, masks, valid)
    plens = jnp.asarray(np.asarray(sb.segment_ids).sum(axis=1), jnp.int32)
    r = jgenerate(jax.tree.map(jnp.asarray, params), CFG, batch, plens, max_new_tokens=MAX_NEW, temperature=0.0,
                  eos_token_id=-1)
    return np.asarray(r.tokens)


@pytest.mark.parametrize("case,world", [("serve_ring", 4), ("serve_ulysses", 2), ("serve_hybrid", 4)])
def test_sp_serving_prefill_matches_jax(groups, jax_tokens, case, world):
    """Every rank emits the JAX single-device greedy tokens (ring over sp 4,
    Ulysses over sp 2, Ulysses 2 x ring 2)."""
    for tokens in _case(groups, world, case):
        np.testing.assert_array_equal(tokens, jax_tokens)
