"""Port parity: ``spatialrgpt_tpu_torch.ops.{layers,quant}`` against their
JAX twins on the same numpy inputs, and the port's import boundary (no
jax anywhere under ``spatialrgpt_tpu_torch``)."""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatialrgpt_tpu.ops import layers as jl
from spatialrgpt_tpu.ops import quant as jq
from spatialrgpt_tpu_torch.ops import layers as tl
from spatialrgpt_tpu_torch.ops import quant as tq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one bf16 rounding of the output, taken at its largest magnitude
BF16_ULP = 2.0**-8


def _both(a, dtype):
    """The same numpy array in both frameworks (fp32 -> bf16 rounds to
    nearest even in both)."""
    if dtype == "bf16":
        return jnp.asarray(a, jnp.bfloat16), torch.tensor(a).to(torch.bfloat16)
    return jnp.asarray(a, jnp.float32), torch.tensor(a)


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _tol(dtype, ref):
    # fp32: accumulation order only; bf16: one output rounding (plus the bias
    # add that F.linear rounds separately)
    return 1e-5 if dtype == "f32" else 2 * BF16_ULP * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_linear_layer_norm_rms_norm(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    kernel = (rng.standard_normal((16, 24)) * 0.25).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    shift = (0.1 * rng.standard_normal(16)).astype(np.float32)
    jx, tx = _both(x, dtype)

    want = _f32(jl.linear(jx, {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}))
    got = _f32(tl.linear(tx, torch.tensor(kernel.T.copy()), torch.tensor(bias)))
    np.testing.assert_allclose(got, want, atol=_tol(dtype, want), rtol=0)

    want = _f32(jl.layer_norm(jx, {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)}, eps=1e-6))
    got = _f32(tl.layer_norm(tx, torch.tensor(scale), torch.tensor(shift), eps=1e-6))
    np.testing.assert_allclose(got, want, atol=_tol(dtype, want), rtol=0)

    jscale, tscale = _both(scale, dtype)
    want = _f32(jl.rms_norm(jx, jscale, eps=1e-5))
    got = _f32(tl.rms_norm(tx, tscale, eps=1e-5))
    np.testing.assert_allclose(got, want, atol=_tol(dtype, want), rtol=0)


def test_qkv_proj_heads():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 8)).astype(np.float32)
    ws = {n: rng.standard_normal((8, d)).astype(np.float32) for n, d in (("wq", 16), ("wk", 8), ("wv", 8))}
    jq_, jk, jv = jl.qkv_proj(jnp.asarray(x), {n: {"kernel": jnp.asarray(w)} for n, w in ws.items()}, 4, 2, 4)
    attn = torch.nn.Module()
    for n, hf in (("wq", "q_proj"), ("wk", "k_proj"), ("wv", "v_proj")):
        lin = torch.nn.Linear(8, ws[n].shape[1], bias=False)
        lin.weight.data = torch.tensor(ws[n].T.copy())
        setattr(attn, hf, lin)
    tq_, tk, tv = tl.qkv_proj(torch.tensor(x), attn, 4, 2, 4)
    for a, b in ((jq_, tq_), (jk, tk), (jv, tv)):
        assert tuple(b.shape) == a.shape
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=1e-5)


def test_activations():
    x = np.linspace(-6, 6, 257, dtype=np.float32)
    for jf, tf in ((jl.gelu_tanh, tl.gelu_tanh), (jl.gelu_erf, tl.gelu_erf), (jl.silu, tl.silu)):
        np.testing.assert_allclose(tf(torch.tensor(x)).numpy(), np.asarray(jf(jnp.asarray(x))), atol=2e-6)


def test_quantize_kv_half_steps_round_to_even():
    """Values exactly at a half step must round half to even in both (never
    truncated by the cast); the scale floor holds for an all-zero vector."""
    half = np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5], np.float32)  # absmax 127: scale 1
    rng = np.random.default_rng(2)
    x = np.stack([half, np.zeros(8, np.float32), rng.standard_normal(8).astype(np.float32) * 3])
    x = np.concatenate([x[None], rng.standard_normal((1, 3, 8)).astype(np.float32)], axis=0)  # (2, 3, 8)
    jq_, js = jq.quantize_kv(jnp.asarray(x))
    tq_, ts = tq.quantize_kv(torch.tensor(x))
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(jq_))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq_.numpy()[0, 0], [127, 0, 2, 2, 0, -2, -2, 4])
    assert ts.numpy()[0, 1] == np.float32(1e-8)
    np.testing.assert_array_equal(
        tq.dequantize_kv(tq_, ts, torch.float32).numpy(),
        np.asarray(jq.dequantize_kv(jq_, js, jnp.float32)),
    )


def test_port_imports_no_jax():
    """Every module of the port (the training and demo slices' included),
    and chip_smoke.py, import without jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import spatialrgpt_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names + ['chip_smoke']:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib']\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "new = {'ops._autograd', 'ops.flash_attention', 'train.optimizer', 'train.step', 'train.trainer',\n"
        "       'ops.layer_norm', 'models.sam', 'models.depth_anything', 'data.device_preprocess', 'demo.pipeline',\n"
        "       'ops.int8_linear', 'ops.quant'}\n"
        "assert {'spatialrgpt_tpu_torch.' + n for n in new} <= set(names), names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    # chip_smoke.py reaches the JAX package's framework-free modules only
    # through the port's re-exports, never with an import of its own
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    imported = [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    imported += [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    assert not [m for m in imported if (m or "").split(".")[0] in ("spatialrgpt_tpu", "jax", "jaxlib")], imported
