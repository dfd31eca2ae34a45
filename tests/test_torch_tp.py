"""Port parity for tensor-parallel and FSDP-sharded serving, the pipeline
and the sharding rules (``spatialrgpt_tpu_torch/parallel/{mesh,pipeline}.py``,
``models/llama.py``'s tensor-parallel collectives, ``serving/``,
``eval/spatial_bench.py`` at ``tp > 1``) on gloo ranks.

The weights are the JAX package's ``init_params`` trees (through the
HF-named bridge), the inputs numpy from seeds.  One group of ranks per
world size (2, 4) runs every case of this file at that size once
(``torch_parallel_cases``); each case is its own test.  Sharded
``generate`` (FSDP, and tensor-parallel with both caches, int8 weight-only
and W8A8) gives the JAX ``generate``'s greedy tokens; the sparse MoE under
tp holds the JAX logits at atol 5e-5 (``tests/test_sequence_parallel.py``);
the pipeline holds the sequential JAX decoder's logits at atol 2e-5 and its
layer gradients at atol 1e-4, rtol 1e-3 (``tests/test_pipeline.py``); the
engine and ``run_bench`` at tp = 2 equal the port's single-process runs,
which the engine and eval tests hold to the JAX package.  ``param_spec``
and ``tp_param_spec`` are held to the JAX functions on every leaf of a
VLM tree.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_cases as cases
from spatialrgpt_tpu import config as jconfig
from spatialrgpt_tpu.data.dataset import to_vlm_inputs
from spatialrgpt_tpu.models import llama as jllama
from spatialrgpt_tpu.models import vlm as jvlm
from spatialrgpt_tpu.ops.quant import quantize_llm
from spatialrgpt_tpu.parallel import mesh as jmesh
from spatialrgpt_tpu.serving import engine as jengine
from spatialrgpt_tpu.serving.generate import generate as jgenerate
from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
from spatialrgpt_tpu_torch.data.splice import expand_rows
from spatialrgpt_tpu_torch.eval import spatial_bench as tsb
from spatialrgpt_tpu_torch.models import llama as tllama
from spatialrgpt_tpu_torch.parallel import mesh as tmesh
from spatialrgpt_tpu_torch.serving.engine import ServingEngine
from spatialrgpt_tpu_torch.utils.weights import export_llama_families, load_from_jax

QUICK_XLA = {"xla_backend_optimization_level": 0}
MAX_NEW = 4
CFG_T = cases.tiny_cfg()
CFG_J = cases.tiny_cfg(jconfig)
# FSDP's rule shards matrices with a dim of 1024 or more: a wider MLP
WIDE_T, WIDE_J = cases.tiny_cfg(intermediate=1024), cases.tiny_cfg(jconfig, intermediate=1024)
BENCH_T = cases.tiny_cfg(vocab=1024).replace(mask_token_id=1009, depth_token_id=1010)
BENCH_J = cases.tiny_cfg(jconfig, vocab=1024).replace(mask_token_id=1009, depth_token_id=1010)
ARRAYS = cases.tiny_batch_arrays(CFG_T)
LLM_KW = dict(vocab_size=128, hidden_size=32, intermediate_size=64, num_hidden_layers=4, num_attention_heads=4,
              num_key_value_heads=2, max_position_embeddings=64)
MOE_KW = dict(LLM_KW, num_hidden_layers=2, num_experts=4, num_experts_per_tok=2, moe_impl="sparse")
PP_IDS = np.random.default_rng(0).integers(0, 128, (4, 12))
MOE_IDS = np.random.default_rng(0).integers(0, 128, (2, 9))


def _fan_in_rows():
    """Rows of 64 whose max |x| falls in either half (tp = 2), and a zero row
    (the scale's floor)."""
    x = np.random.default_rng(7).standard_normal((9, 64)).astype(np.float32)
    x[::2, 5] = 40.0
    x[1::2, 50] = -40.0
    x[8] = 0.0
    return x


FAN_IN_X = _fan_in_rows()


def _init(cfg, seed):
    return jax.tree.map(np.asarray, jax.jit(jvlm.init_params, static_argnums=1, compiler_options=QUICK_XLA)(
        jax.random.PRNGKey(seed), cfg))


def _llm(kw, seed, stack=False):
    cfg = jconfig.LlamaConfig(**kw)
    p = jllama.init_params(jax.random.PRNGKey(seed), cfg)
    return cfg, (jllama.stack_experts(p) if stack else p), {
        k: np.asarray(v, np.float32) for k, v in export_llama_families(jax.tree.map(np.asarray, p)).items()}


@pytest.fixture(scope="module")
def params():
    return {"tiny": _init(CFG_J, 3), "wide": _init(WIDE_J, 2), "bench": _init(BENCH_J, 0)}


@pytest.fixture(scope="module")
def llms():
    return {"pp": _llm(LLM_KW, 1), "moe": _llm(MOE_KW, 0, stack=True)}


def _requests():
    """The reference engine dryrun's two requests, and a third."""
    rng = np.random.default_rng(0)
    size = CFG_T.vision.image_size
    out = []
    for pids in ([5, IMAGE_TOKEN_INDEX, CFG_T.mask_token_id, 8], [9, IMAGE_TOKEN_INDEX, 11, 12, 13],
                 [IMAGE_TOKEN_INDEX, 21, 22]):
        sb = expand_rows([np.asarray(pids, np.int64)], None, max_len=64, tokens_per_image=4,
                         mask_token_id=CFG_T.mask_token_id, depth_token_id=CFG_T.depth_token_id,
                         regions_per_image=2, pad_to=32)
        arrays = (sb, rng.standard_normal((1, size, size, 3)).astype(np.float32),
                  rng.standard_normal((1, size, size, 3)).astype(np.float32),
                  (rng.random((1, 2, size, size)) > 0.5).astype(np.float32), np.ones((1, 2), bool))
        out.append((arrays, int(sb.segment_ids.sum())))
    return out


REQUESTS = _requests()


def _groups(params, llms, root):
    tiny, wide = params["tiny"], params["wide"]
    pp, moe = llms["pp"][2], llms["moe"][2]

    def gen(fn, **kw):
        return (fn, {"cfg": CFG_T, "arrays": ARRAYS, "max_new": MAX_NEW, **kw})

    def pipe(**kw):
        return ("pipeline", dict(llm_sd=pp, cfg_kw=LLM_KW, ids=PP_IDS, **kw))

    return {
        2: {
            "fsdp": gen("fsdp_generate", params=wide, cfg=WIDE_T),
            "tp_float": gen("tp_generate", params=tiny),
            "tp_float_kvq": gen("tp_generate", params=tiny, kv_quant=True),
            "tp_int8": gen("tp_generate", params=tiny, quant="int8"),
            "tp_w8a8": gen("tp_generate", params=tiny, quant="w8a8", kv_quant=True),
            "fan_in_quant": ("fan_in_quant", dict(x=FAN_IN_X)),
            "tp_moe": ("tp_moe_logits", dict(llm_sd=moe, cfg_kw=MOE_KW, ids=MOE_IDS)),
            "tp_engine": ("tp_engine", dict(params=tiny, cfg=CFG_T, requests=REQUESTS, max_new=MAX_NEW,
                                            kv_quant=True)),
            "tp_engine_bf16_cache": ("tp_engine", dict(params=tiny, cfg=CFG_T, requests=REQUESTS, max_new=MAX_NEW,
                                                       kv_quant=False)),
            "tp_engine_chunked": ("tp_engine", dict(params=tiny, cfg=CFG_T, requests=REQUESTS, max_new=MAX_NEW,
                                                    kv_quant=True, prefill_chunk=8)),
            "tp_run_bench": ("tp_run_bench", dict(params=params["bench"], cfg=BENCH_T, root=str(root / "bench"))),
            "pp2": pipe(pp_microbatches=2),
            "pp2_remat": pipe(pp_microbatches=2, remat=True),
            "pp2_moe": ("pipeline", dict(llm_sd=llms["moe"][2], cfg_kw=MOE_KW, ids=PP_IDS, pp_microbatches=2,
                                         sparse=True)),
        },
        4: {
            "fsdp": gen("fsdp_generate", params=wide, cfg=WIDE_T),
            "pp4": pipe(pp_microbatches=4, grads=True),
            "pp4_m2": pipe(pp_microbatches=2),
        },
    }


@pytest.fixture(scope="module")
def groups(params, llms, tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    out = {"root": root}
    for world, group in _groups(params, llms, root).items():
        out[world] = cases.spawn(world, [(n, fn, kw) for n, (fn, kw) in group.items()], root / f"w{world}")
    return out


def _case(groups, world, name):
    results = [r[name] for r in groups[world]]
    for r in results:
        assert not (isinstance(r, dict) and "error" in r), r["error"]
    return results


def _jax_tokens(params, cfg, **kw):
    sb, img, dep, masks, valid = ARRAYS
    batch = to_vlm_inputs(sb, img, dep, masks, valid)
    plens = jnp.asarray(np.asarray(sb.segment_ids).sum(axis=1), jnp.int32)
    r = jgenerate(jax.tree.map(jnp.asarray, params), cfg, batch, plens, max_new_tokens=MAX_NEW, temperature=0.0,
                  eos_token_id=-1, **kw)
    return np.asarray(r.tokens)


# ---------------------------------------------------------------------------
# sharded generate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world", [2, 4])
def test_fsdp_sharded_generate_matches_jax(groups, params, world):
    """``generate`` on FSDP-sharded parameters (some of them DTensors)
    emits the JAX single-device greedy tokens on every rank."""
    want = _jax_tokens(params["wide"], WIDE_J)
    for r in _case(groups, world, "fsdp"):
        assert r["sharded"] > 0
        np.testing.assert_array_equal(r["tokens"], want)


@pytest.mark.parametrize("case,kv_quant", [("tp_float", False), ("tp_float_kvq", True)])
def test_tp_generate_matches_jax(groups, params, case, kv_quant):
    """tp = 2 (2 q heads, 1 kv head a rank), with the activation-dtype and
    the int8 cache."""
    want = _jax_tokens(params["tiny"], CFG_J, kv_quant=kv_quant)
    for r in _case(groups, 2, case):
        assert r["local_q_heads"] == CFG_T.llm.num_attention_heads // 2
        np.testing.assert_array_equal(r["tokens"], want)


def test_fan_in_quantization_equals_the_gathered_rows(groups):
    """A W8A8 fan-in slice at tp = 2 quantizes its columns by the whole rows'
    scales from an all-reduce MAX of the rows' maxima: bit-equal to
    gathering the whole rows, quantizing them and keeping this rank's
    columns (the rows' maxima lie on both ranks)."""
    results = _case(groups, 2, "fan_in_quant")
    half = FAN_IN_X.shape[1] // 2
    assert (np.abs(FAN_IN_X[:8, :half]).max(1) > np.abs(FAN_IN_X[:8, half:]).max(1)).tolist() == [True, False] * 4
    for r in results:
        np.testing.assert_array_equal(r["xq"], r["gathered_xq"])
        np.testing.assert_array_equal(r["scale"], r["gathered_scale"])
    np.testing.assert_array_equal(results[0]["scale"], results[1]["scale"])
    assert results[0]["scale"][8] == np.float32(1e-12)


@pytest.mark.parametrize("case,act_quant", [("tp_int8", False), ("tp_w8a8", True)])
def test_tp_generate_quantized_matches_jax(groups, params, case, act_quant):
    """tp = 2 over an int8 weight-only decoder and a W8A8 one (whose fan-in
    slices quantize the whole rows, as the reference's GSPMD program)."""
    p = dict(params["tiny"])
    p["llm"] = jax.tree.map(np.asarray, quantize_llm(jax.tree.map(jnp.asarray, p["llm"]), bits=8,
                                                     act_quant=act_quant))
    want = _jax_tokens(p, CFG_J, kv_quant=act_quant)
    for r in _case(groups, 2, case):
        np.testing.assert_array_equal(r["tokens"], want)


def test_tp_sparse_moe_matches_jax(groups, llms):
    cfg, p, _ = llms["moe"]
    pos = jnp.broadcast_to(jnp.arange(MOE_IDS.shape[1]), MOE_IDS.shape)
    want = np.asarray(jllama.forward_logits(p, cfg, input_ids=jnp.asarray(MOE_IDS), position_ids=pos))
    for got in _case(groups, 2, "tp_moe"):
        np.testing.assert_allclose(got, want, atol=5e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the engine and run_bench at tp = 2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case,kv_quant", [("tp_engine", True), ("tp_engine_bf16_cache", False)])
def test_tp_engine_matches_single_process(groups, params, case, kv_quant):
    model = load_from_jax(params["tiny"], CFG_T, "cpu")
    eng = ServingEngine(model, CFG_T, num_slots=2, prompt_bucket=32, max_new_tokens=MAX_NEW, attn_impl="xla",
                        kv_quant=kv_quant, dtype=torch.float32)
    for arrays, plen in REQUESTS:
        eng.submit(cases._inputs(arrays), plen, max_new_tokens=MAX_NEW)
    want = sorted((r.request_id, list(r.tokens)) for r in eng.run_until_drained(max_steps=100))
    for got in _case(groups, 2, case):
        assert got == want


def test_tp_chunked_engine_matches_jax(groups, params):
    """The fused chunked prefill at tp = 2 (chunk 8, two rows, the int8
    cache; each rank stages its kv head) gives the JAX chunked engine's
    tokens on one device (which ``tests/test_serving_engine.py`` holds to
    its tp = 2 engine)."""
    eng = jengine.ServingEngine(jax.tree.map(jnp.asarray, params["tiny"]), CFG_J, num_slots=2, prompt_bucket=32,
                                max_new_tokens=MAX_NEW, kv_quant=True, prefill_chunk=8, chunk_rows=2,
                                dtype=jnp.float32)
    for arrays, plen in REQUESTS:
        eng.submit(to_vlm_inputs(*arrays), plen, max_new_tokens=MAX_NEW)
    want = sorted((r.request_id, [int(t) for t in r.tokens]) for r in eng.run_until_drained(max_steps=100))
    for got in _case(groups, 2, "tp_engine_chunked"):
        assert got == want


def test_tp_run_bench_matches_single_process(groups, params):
    root = str(groups["root"] / "bench")
    kw = cases.bench_cfg_kw(root)
    ans = tsb.run_bench(tsb.BenchConfig(answers_file=os.path.join(root, "single", "answers.jsonl"), **kw),
                        model=cases.bench_model(params["bench"], BENCH_T), device="cpu")
    with open(ans) as f:
        want = [json.loads(line) for line in f]
    got = _case(groups, 2, "tp_run_bench")
    assert got[0] == want and len(want) == 3
    assert got[1] is None  # only rank 0 writes


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


def _pp_ref(llms, key="pp"):
    cfg, p, _ = llms[key]
    pos = jnp.broadcast_to(jnp.arange(PP_IDS.shape[1]), PP_IDS.shape)
    seg = jnp.ones(PP_IDS.shape, jnp.int32)
    return cfg, p, pos, seg, np.asarray(
        jllama.forward_logits(p, cfg, input_ids=jnp.asarray(PP_IDS), position_ids=pos, segment_ids=seg))


@pytest.mark.parametrize("case,world", [("pp2", 2), ("pp4", 4), ("pp4_m2", 4)])
def test_pipeline_forward_matches_sequential(groups, llms, case, world):
    want = _pp_ref(llms)[-1]
    for r in _case(groups, world, case):
        np.testing.assert_allclose(r["logits"], want, atol=2e-5, rtol=1e-4)


def test_pipeline_gradients_match_sequential(groups, llms):
    """pp = 4, 4 microbatches: each stage's layer gradients of
    sum(logits**2) against ``jax.grad`` through the sequential decoder."""
    cfg, p, pos, seg, _ = _pp_ref(llms)

    def loss(layers):
        out = jllama.forward_logits(dict(p, layers=layers), cfg, input_ids=jnp.asarray(PP_IDS), position_ids=pos,
                                    segment_ids=seg)
        return jnp.sum(jnp.square(out))

    g = jax.jit(jax.grad(loss), compiler_options=QUICK_XLA)(p["layers"])
    want = export_llama_families(dict(jax.tree.map(np.asarray, p), layers=jax.tree.map(np.asarray, g)))
    seen = set()
    for r in _case(groups, 4, "pp4"):
        for name, grad in r["grads"].items():
            np.testing.assert_allclose(grad, want[name], atol=1e-4, rtol=1e-3, err_msg=name)
            seen.add(name)
    assert seen == {n for n in want if n.startswith("model.layers.")}


def test_pipeline_remat_matches(groups):
    """``remat=True`` gives the same logits, bit for bit."""
    a, b = _case(groups, 2, "pp2")[0]["logits"], _case(groups, 2, "pp2_remat")[0]["logits"]
    np.testing.assert_array_equal(a, b)


def test_pipeline_with_sparse_moe(groups, llms):
    cfg, p, _ = llms["moe"]
    pos = jnp.broadcast_to(jnp.arange(PP_IDS.shape[1]), PP_IDS.shape)
    want = np.asarray(jllama.forward_logits(p, cfg, input_ids=jnp.asarray(PP_IDS), position_ids=pos,
                                            segment_ids=jnp.ones(PP_IDS.shape, jnp.int32)))
    for r in _case(groups, 2, "pp2_moe"):
        np.testing.assert_allclose(r["logits"], want, atol=2e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# the sharding rules
# ---------------------------------------------------------------------------


def _leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [("/".join(str(p) for p in path), tuple(np.shape(x))) for path, x in flat]


def test_spec_rules_are_the_references_on_every_leaf(params):
    """The port's copies of ``param_spec`` and ``tp_param_spec`` give the
    JAX functions' specs on every leaf of a VLM tree (float, quantized and
    with stacked experts)."""
    wide = params["wide"]
    q = dict(wide, llm=jax.tree.map(np.asarray, quantize_llm(jax.tree.map(jnp.asarray, wide["llm"]), bits=8)))
    leaves = _leaves(wide) + _leaves(q) + [(f"llm/layers/0/experts_stacked/{n}/kernel", (4, 64, 1024))
                                           for n in ("gate", "up", "down")]
    sharded = 0
    for path, shape in leaves:
        assert tmesh.param_spec(path, shape) == tuple(jmesh.param_spec(path, shape)), path
        assert tmesh.tp_param_spec(path, shape) == tuple(jmesh.tp_param_spec(path, shape)), path
        sharded += tmesh.param_spec(path, shape) != ()
    assert sharded > 0


def test_port_parameters_map_to_their_reference_twins(params):
    """Every parameter of the port's model (built from the wide tree): its
    ``jax_view`` has its JAX twin's shape, the rules give the twin's specs
    on the view, and FSDP shards the port's dim that is the twin's."""
    wide = params["wide"]
    # tag every JAX leaf with its index, carry the tree through the bridge,
    # and read which leaf each port parameter came from
    flat, treedef = jax.tree_util.tree_flatten_with_path(wide)
    tagged = jax.tree_util.tree_unflatten(treedef, [np.full(np.shape(x), float(i), np.float32)
                                                    for i, (_, x) in enumerate(flat)])
    model = load_from_jax(tagged, WIDE_T, "cpu")
    owners = tmesh._owners(model)
    assert owners
    for name, (mod, p) in owners.items():
        i = int(p.flatten()[0])
        path, leaf = flat[i]
        jpath = "/".join(str(k) for k in path)
        view = tmesh.jax_view(name, mod, p)
        assert view.shape == np.shape(leaf), name
        assert tmesh.param_spec(view.path, view.shape) == tuple(jmesh.param_spec(jpath, np.shape(leaf))), name
        if name.startswith("llm."):
            assert tmesh.tp_param_spec(view.path, view.shape) == tuple(jmesh.tp_param_spec(jpath, np.shape(leaf)))
        dim = tmesh.fsdp_shard_dim(name, mod, p)
        spec = jmesh.param_spec(jpath, np.shape(leaf))
        if dim is None:
            assert all(a is None for a in spec), name
        else:
            assert p.shape[dim] == np.shape(leaf)[list(spec).index("fsdp")], name
