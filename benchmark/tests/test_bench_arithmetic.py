"""The yardstick's arithmetic: operation counts by hand, the percentile
with missing requests, the idle share of a synthetic kernel timeline, the
correctness readings."""

import math

import checks
import flops
import timeline
import window
from conftest import BENCH

import json
import os


def config(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        return json.load(f)


def test_decoder_layer_ops_by_hand():
    m = config("mistral-7b")
    H, I = 4096, 14336
    layer = 2 * H * (32 * 128) + 2 * 2 * H * (8 * 128) + 2 * (32 * 128) * H + 3 * 2 * H * I
    assert flops.decoder_token_ops(m).bf16 == 32 * layer and flops.decoder_token_ops(m).int8 == 0
    x = config("mixtral-8x7b-w8a8")
    moe_layer = 2 * H * (32 * 128) + 2 * 2 * H * (8 * 128) + 2 * (32 * 128) * H + 2 * H * 8 + 2 * 3 * 2 * H * I
    got = flops.decoder_token_ops(x)
    assert got.int8 == 32 * moe_layer and got.bf16 == 0  # 2 of 8 experts, in the W8A8 products


def test_train_step_counts_frozen_dx_only():
    m = config("mistral-7b")
    lengths = [1000, 900]
    step = flops.train_step_ops(m, lengths, 2)
    dec = flops.decoder_token_ops(m).bf16 * 1900 + flops.head_ops(m).bf16 * 1900
    attn = flops.attention_ops(m, 1000 * 1001 // 2 + 900 * 901 // 2).bf16
    images = flops.image_ops(m, 2).bf16 * 2
    trained = flops.trained_ops(m, 2).bf16
    # forward once; the frozen decoder's dx (1x products, 2x attention); the trained modules' dx + dW (2x)
    assert math.isclose(step.bf16, dec + attn + images + dec + 2 * attn + 4 * trained)
    v = m["vision"]
    T, C = (384 // 14) ** 2, 1152
    tower = 2 * 3 * 14 * 14 * C * T + 26 * (2 * T * (4 * C * C + 2 * C * 4304) + 4 * T * T * C)
    assert math.isclose(flops.tower_ops(m).bf16, tower)  # 26 of 27 layers, by hand
    assert math.isclose(flops.image_ops(m, 2).bf16, 2 * tower + trained)  # the tower takes no backward


def test_percentile_counts_unfinished_requests_as_missing():
    done = [float(i) for i in range(1, 20)]
    assert window.percentile(done, 95) == 19.0
    assert window.percentile(done + [math.inf], 95) == 19.0  # 1 of 20 missing: the 19th value
    assert math.isinf(window.percentile(done[:-1] + [math.inf] * 2, 95))  # 2 of 20 missing
    assert window.percentile(done + [math.inf], 50) == 10.0
    assert math.isinf(window.percentile([], 95))


def test_quartile_spread_is_python_s_quartiles_over_the_median():
    assert math.isclose(window.quartile_spread([1.0, 2.0, 3.0, 4.0, 5.0]), (4.5 - 1.5) / 3.0)
    # the farthest run from the median is left out: 100 goes, the rest spread as [1, 2, 3, 4, 5]
    assert math.isclose(window.spread_without_farthest([1.0, 2.0, 3.0, 4.0, 5.0, 100.0]), (4.5 - 1.5) / 3.0)


def test_idle_share_on_a_synthetic_timeline():
    ev = [{"ph": "X", "cat": "user_annotation", "name": timeline.SLICE, "ts": 0, "dur": 100, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 5, "dur": 30, "pid": 1, "tid": 1},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 10, "dur": 20, "pid": 0, "tid": 7},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 25, "dur": 15, "pid": 0, "tid": 7},  # overlaps k1
          {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 60, "dur": 10, "pid": 0, "tid": 8},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 95, "dur": 20, "pid": 0, "tid": 7}]  # cut at the end
    tl = timeline.Timeline(ev)
    assert math.isclose(tl.busy_s, (30 + 10 + 5) * 1e-6)
    assert math.isclose(tl.idle_share(), 1 - 45 / 100)
    secs, n = tl.kernel_seconds(r"^k1$")
    assert n == 2 and math.isclose(secs, 25e-6)
    gaps = dict(tl.idle_gaps())
    assert math.isclose(gaps["aten::mm"], 10e-6) and math.isclose(gaps["host idle"], (20 + 25) * 1e-6)


def test_norm_gap_takes_the_worst_leaf_and_leaves_out_nought_leaves():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "z": 1e-6}
    assert checks.counted_leaves(ref) == ["a", "b", "c"]
    prog = {"a": 1.1, "b": 2.0, "c": 3.0, "z": 5.0}
    assert math.isclose(checks.norm_gap(prog, ref, ["a", "b", "c"]), 0.25)  # c: 1 / max(4, median 2)
    assert math.isclose(checks.norm_gap({"a": 0.5, "b": 2, "c": 4}, ref, ["a", "b", "c"]), 0.25)  # a: 0.5 / 2
    assert math.isclose(checks.loss_gap([1.0, 2.2], [1.0, 2.0]), 0.1)


def test_k4_bound_counts_causal_pairs():
    m = config("mistral-7b")
    b = flops.k4_bounds(m, 1, 4096, [1000])
    assert math.isclose(b["fwd"], max(4 * 128 * 32 * 1000 * 1001 / 2 / 989e12,
                                      (1000 * 48 * 128 * 2 + 4096 * 4 + 4096 * 32 * 128 * 2 + 4096 * 32 * 4) / 3.35e12))
    assert b["dkv"] > b["dq"] > b["fwd"]
