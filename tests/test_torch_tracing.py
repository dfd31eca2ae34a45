"""The port's profiler spans on the CPU: ``utils/profiling.py::annotate``
opens a ``record_function`` range only while a profiler runs; the serving
engine's ``step`` opens ``engine.admit`` around its admission, an
``engine.prefill[n]`` inside it per admission prefill of n requests, and
``engine.decode`` around its decode window, with ``engine.eager[k]``
inside it; K8 / K9's span names (``ops/int8_linear.py::gemm_span_name``)
read back through the benchmark's parser (``benchmark/spans.py``), and
recorded for a graph's replay; the replayed share of the decode windows
(``benchmark/graphs.py``) on synthetic traces."""

import json
import os
import sys

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
from spatialrgpt_tpu_torch.ops import int8_linear
from spatialrgpt_tpu_torch.serving import engine as engine_mod
from spatialrgpt_tpu_torch.serving.engine import ServingEngine
from spatialrgpt_tpu_torch.utils import profiling
from spatialrgpt_tpu_torch.utils.weights import init_random

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.append(BENCH)
import graphs  # noqa: E402  (benchmark/graphs.py)
import harness  # noqa: E402  (benchmark/harness.py)
import spans  # noqa: E402  (benchmark/spans.py)
from timeline import Timeline  # noqa: E402  (benchmark/timeline.py)

# a tiny config, eos at -1: every request runs its whole budget
CFG = SpatialRGPTConfig(
    llm=LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64, num_hidden_layers=2, num_attention_heads=4,
                    num_key_value_heads=2, eos_token_id=-1),
    vision=SiglipVisionConfig(hidden_size=16, intermediate_size=32, num_hidden_layers=2, num_attention_heads=2,
                              image_size=56, patch_size=14),
    projector=ProjectorConfig(mm_hidden_size=16, hidden_size=32),
    region=RegionExtractorConfig(mm_hidden_size=16, hidden_size=32, ada_pool_size=4),
    mask_token_id=60, depth_token_id=61,
)
PROMPTS = [[5, IMAGE_TOKEN_INDEX, 60, 61, 8], [IMAGE_TOKEN_INDEX, 7], [1, IMAGE_TOKEN_INDEX, 60, 9, 10]]


@pytest.fixture(scope="module")
def model():
    return init_random(CFG, "cpu", torch.float32, seed=0)


def _requests():
    """One batch-1 request per prompt (RGB, depth, 2 masks) and its length."""
    rng = np.random.default_rng(4)
    out = []
    for p in PROMPTS:
        sb = expand_rows([np.asarray(p, np.int64)], None, max_len=64, tokens_per_image=4, mask_token_id=60,
                         depth_token_id=61, regions_per_image=2, pad_to=16)
        pix = (rng.standard_normal((1, 56, 56, 3)), rng.standard_normal((1, 56, 56, 3)),
               (rng.random((1, 2, 56, 56)) > 0.5).astype(np.float32), np.ones((1, 2), bool))
        out.append((VLMInputs.from_spliced(sb, *pix, device="cpu"), int(sb.segment_ids.sum())))
    return out


def _two_steps(model):
    """3 requests on 4 slots, admissions of at most 2: ``step(2)`` admits a
    prefill of 2, then of 1, and decodes a window of 2; the next step
    admits nothing and decodes the last window.  Returns the requests'
    tokens."""
    eng = ServingEngine(model, CFG, num_slots=4, prompt_bucket=16, max_new_tokens=4, admit_width=2,
                        dtype=torch.float32)
    for inputs, plen in _requests():
        eng.submit(inputs, plen, max_new_tokens=4)
    reqs = list(eng.queue)
    eng.step(2)
    assert len(eng.step(2)) == 3
    return [r.tokens for r in reqs]


def _host_spans(path):
    """(start, end, name) of the trace's host ranges, in start order."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def test_engine_step_writes_its_phase_spans(model, tmp_path):
    """Under ``profiling.trace`` two ``step(2)`` calls write, in order:
    ``engine.admit`` holding ``engine.prefill[2]`` then ``engine.prefill[1]``,
    ``engine.decode`` after it holding ``engine.eager[2]`` (the CPU runs the
    window eagerly); then an ``engine.admit`` with no prefill and an
    ``engine.decode`` holding ``engine.eager[2]``.  No span overlaps a span
    of another phase."""
    with profiling.trace(str(tmp_path)) as d:
        _two_steps(model)
    host = [s for s in _host_spans(os.path.join(d, "trace.json")) if s[2].startswith("engine.")]
    assert [n for _, _, n in host] == ["engine.admit", "engine.prefill[2]", "engine.prefill[1]", "engine.decode",
                                       "engine.eager[2]", "engine.admit", "engine.decode", "engine.eager[2]"]
    admit, pre2, pre1, decode, eager = host[:5]
    assert admit[0] <= pre2[0] < pre2[1] <= pre1[0] < pre1[1] <= admit[1] <= decode[0] < decode[1] <= host[5][0]
    assert decode[0] <= eager[0] < eager[1] <= decode[1]
    assert host[5][1] <= host[6][0] <= host[7][0] < host[7][1] <= host[6][1]


def test_no_span_runs_without_a_profiler(model, monkeypatch, tmp_path):
    """With no profiler running ``annotate`` returns the shared no-op: a
    ``record_function`` or a naming function that raises is never reached,
    and the engine gives the tokens that it gives under a profiler."""
    with profiling.trace(str(tmp_path)):
        traced = _two_steps(model)

    def fail(*args, **kwargs):
        raise AssertionError("a span was opened with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", fail)
    monkeypatch.setattr(engine_mod, "PREFILL_SPAN", fail)
    assert profiling.annotate(fail, 1) is profiling.NO_SPAN
    assert profiling.annotate("engine.admit") is profiling.NO_SPAN
    assert _two_steps(model) == traced
    assert all(len(t) == 4 for t in traced)


def test_annotate_opens_a_range_only_under_a_profiler(tmp_path):
    """Under a profiler ``annotate`` opens a range of its name, or of the
    name its naming function makes from its arguments, nested as the code nests."""
    gemm = (int8_linear.gemm_span_name, "k9", int8_linear.FORM_LARGE, 2048, 1024, 4096, False, True)
    with profiling.trace(str(tmp_path)) as d:
        with profiling.annotate("outer.{}:{}".format, 3, "x"):
            with profiling.annotate(*gemm):
                torch.ones(8, 8) @ torch.ones(8, 8)
    (a0, a1, outer), (b0, b1, inner) = _host_spans(os.path.join(d, "trace.json"))
    assert (outer, inner) == ("outer.3:x", "k9.large:2048x1024x4096+bias") and a0 <= b0 < b1 <= a1


@pytest.mark.parametrize("add", [False, True])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("kernel,form", [("k8", int8_linear.FORM_DECODE), ("k8", int8_linear.FORM_LARGE),
                                         ("k9", int8_linear.FORM_DECODE), ("k9", int8_linear.FORM_LARGE)])
def test_gemm_span_name_round_trips_through_the_reader(kernel, form, add, bias):
    """``gemm_span_name`` and ``benchmark/spans.py::parse_gemm`` agree on
    every (kernel, form, addend, bias), and the reader pairs the name with
    the kernel that the form launches."""
    name = int8_linear.gemm_span_name(kernel, form, 64, 14336, 4096, add, bias)
    form_name = "decode" if form == int8_linear.FORM_DECODE else "large"
    assert spans.parse_gemm(name) == (kernel, form_name, 64, 14336, 4096, add, bias)
    assert (kernel, form_name) in spans.GEMM_KERNELS
    assert spans.parse_gemm(name + "x") is None and spans.parse_gemm("engine.decode") is None


def test_gemm_bound_counts_the_launched_shape():
    """K8's decode gate at 64 rows is bound by its bytes (the int8 weight
    read once), K8's admission gate at 3072 rows by its int8 operations,
    K9 by bf16 operations at twice K8's time; the addend adds 4 bytes an
    output."""
    M, N, K = 64, 14336, 4096
    weight_read = (M * K + N * K + 4 * M + 4 * N + 2 * M * N) / spans.flops.PEAK_BYTES_S
    assert spans.gemm_bound_s("k8", M, N, K, False, False) == pytest.approx(weight_read)
    with_add = spans.gemm_bound_s("k8", M, N, K, True, False) - spans.gemm_bound_s("k8", M, N, K, False, False)
    assert with_add == pytest.approx(4 * M * N / spans.flops.PEAK_BYTES_S)
    big = 3072
    k8 = spans.gemm_bound_s("k8", big, N, K, False, False)
    assert k8 == pytest.approx(2 * big * N * K / spans.flops.PEAK["int8"])
    assert spans.gemm_bound_s("k9", big, N, K, False, False) == pytest.approx(k8 * 1979 / 989)


def test_recorded_gemm_spans_open_in_order(tmp_path):
    """``record_spans`` collects the span name of each K8 / K9 launch made
    inside it, in launch order, an inner block apart from the outer, with
    no profiler running; ``open_spans`` then opens one span of each name, in
    that order, inside the span that holds it (the replay of a graph)."""
    args = [("k8", int8_linear.FORM_DECODE, 64, 14336, 4096, None, None),
            ("k9", int8_linear.FORM_DECODE, 64, 4096, 14336, torch.zeros(1), None),
            ("k8", int8_linear.FORM_LARGE, 3072, 1024, 4096, None, torch.zeros(1))]
    names = [int8_linear.gemm_span_name(k, f, M, N, K, a is not None, b is not None) for k, f, M, N, K, a, b in args]
    with int8_linear.record_spans() as outer:
        assert int8_linear._span(*args[0]) is profiling.NO_SPAN
        with int8_linear.record_spans() as inner:
            int8_linear._span(*args[1])
        int8_linear._span(*args[2])
    assert (outer, inner, int8_linear._recorded) == ([names[0], names[2]], [names[1]], None)
    with profiling.trace(str(tmp_path)) as d:
        with profiling.annotate(engine_mod.REPLAY_SPAN, 3):
            int8_linear.open_spans(outer + inner)
    (r0, r1, replay), *opened = _host_spans(os.path.join(d, "trace.json"))
    assert replay == "engine.replay[3]" and [n for _, _, n in opened] == [names[0], names[2], names[1]]
    assert all(r0 <= a <= b <= r1 for a, b, _ in opened)


MAIN = {"pid": 1, "tid": 1}


def _slice(windows):
    """A 1000 us traced slice from 1000: an ``engine.admit`` (1000-1100) and
    one kernel, then a window each 100 us from 1100: ``"decode"`` an
    ``engine.decode`` span alone, another name an ``engine.decode`` span
    holding a span of that name, ``"orphan"`` an ``engine.replay[8]`` span
    in no decode span."""
    def host(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, **MAIN}

    ev = [host("bench.slice", 1000, 1000), host("engine.admit", 1000, 100),
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 1010, "dur": 10, "pid": 0, "tid": 7}]
    for i, window in enumerate(windows):
        t = 1100 + 100 * i
        if window != "orphan":
            ev.append(host("engine.decode", t, 90))
        if window != "decode":
            ev.append(host("engine.replay[8]" if window == "orphan" else window, t + 5, 60))
    return {"timeline": Timeline(ev)}


@pytest.mark.parametrize("windows,share", [
    (["engine.replay[8]"] * 3, 100.0),
    (["engine.eager[8]"] * 3, 0.0),
    (["engine.eager[8]", "engine.replay[8]", "engine.replay[8]", "engine.eager[8]"], 50.0),
    (["engine.replay[8]", "decode", "engine.replay[8]", "engine.replay[1]"], 75.0),
], ids=["replayed", "eager", "mixed", "unmarked_window"])
def test_decode_replay_share_reads_the_replayed_windows(windows, share):
    """``benchmark/graphs.py::decode_replay_share`` and the two metric files
    that take it: the share of the slice's ``engine.decode`` spans that hold
    an ``engine.replay[k]`` span, in percent."""
    ctx = _slice(windows)
    assert graphs.decode_replay_share(ctx) == share
    for metric in ("decode_replay_share.serve", "decode_replay_share.rate"):
        assert harness.read_metric(metric, ctx) == share


@pytest.mark.parametrize("windows", [[], ["decode", "decode"], ["orphan", "orphan"]],
                         ids=["no_window", "no_marker", "no_decode_span"])
def test_decode_replay_share_is_none_without_its_spans(windows):
    """None where the slice holds no ``engine.decode`` span, or decode spans
    with neither an ``engine.replay[k]`` nor an ``engine.eager[k]`` span
    inside (a program that opens neither), and where there is no trace."""
    assert graphs.decode_replay_share(_slice(windows)) is None
    assert graphs.decode_replay_share({}) is None
