"""The readers of the port's spans (``spans.py``) and the metric files
that take them, on a ``Timeline`` of synthetic events: known values where
the trace holds the spans, None where it holds none (a program that opens
no span) or where no int8 GEMM span pairs with a kernel."""

import pytest

import flops
import harness
import spans
from conftest import small_config, small_traffic
from timeline import Timeline

MAIN = {"pid": 1, "tid": 1}
METRICS = {"admit_share": spans.admit_share, "admit_idle_share": spans.admit_idle_share,
           "decode_idle_share": spans.decode_idle_share, "admit_width": spans.admit_width}
GEMMS = [("k8.large:3072x14336x4096", 1090, "void srgpt::qgemm::large_kernel<false>(CUtensorMap_st, int)", 1100),
         ("k8.decode:64x14336x4096+bias", 1390, "void srgpt::qgemm::decode_kernel<true, 64>(CUtensorMap_st)", 1400),
         ("k9.decode:64x4096x14336+add", 1590, "void srgpt::qgemm::decode_kernel<false, 64>(CUtensorMap_st)", 1600)]


def host(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, **MAIN}


def kernel(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7}


def events(with_spans=True, gemms=GEMMS):
    """A 1000 us slice from 1000: an admission crossing its start (900-1300)
    with prefills of 8 and 4, a decode window (1300-1900), an admission
    crossing its end (1900-2100); on the card the K8 / K9 kernels (100 us
    each) and a copy crossing the end (1950-2050)."""
    ev = [host("bench.slice", 1000, 1000), kernel("Memcpy HtoD", 1950, 100, "gpu_memcpy")]
    ev += [kernel(k, kt, 100) for _, _, k, kt in gemms]
    if with_spans:
        ev += [host("engine.admit", 900, 400), host("engine.prefill[8]", 1050, 100),
               host("engine.prefill[4]", 1150, 100), host("engine.decode", 1300, 600),
               host("engine.admit", 1900, 200), host("aten::mm", 1310, 5, "cpu_op")]
        ev += [host(name, ts, 5) for name, ts, _, _ in gemms]
    return ev


def bound_of(name):
    kernel, _, M, N, K, add, bias = spans.parse_gemm(name)
    return spans.gemm_bound_s(kernel, M, N, K, add, bias)


def ctx_of(ev):
    return {"timeline": Timeline(ev)}


def test_each_reader_gives_its_known_value():
    ctx = ctx_of(events())
    assert spans.admit_share(ctx) == pytest.approx(100 * (300 + 100) / 1000)  # both admissions clipped
    # inside the admissions (400 us) the card ran the large K8 (100) and half the copy (50)
    assert spans.admit_idle_share(ctx) == pytest.approx(100 * 250 / 400)
    assert spans.decode_idle_share(ctx) == pytest.approx(100 * 400 / 600)  # two decode kernels in 600 us
    assert spans.admit_width(ctx) == 6
    bound = sum(bound_of(name) for name, _, _, _ in GEMMS)
    assert spans.int8_gemm_roofline(ctx) == pytest.approx(100 * bound / 300e-6)
    assert 0 < spans.int8_gemm_roofline(ctx) <= 100


def test_the_metric_files_read_through_the_readers():
    ctx = ctx_of(events())
    for cell in ("serve", "rate"):
        for name, reader in METRICS.items():
            assert harness.read_metric(f"{name}.{cell}", ctx) == reader(ctx)
    assert harness.read_metric("roofline.int8_gemm.serve", ctx) == spans.int8_gemm_roofline(ctx)


def test_a_trace_without_the_spans_reads_nothing():
    ctx = ctx_of(events(with_spans=False))
    assert ctx["timeline"].idle_share() is not None  # the card ran, but no span says in which phase
    for reader in list(METRICS.values()) + [spans.int8_gemm_roofline]:
        assert reader(ctx) is None
        assert reader({}) is None


def test_unpaired_gemm_spans_read_nothing():
    """A qgemm kernel with no span, or a span whose kernel the trace lacks
    or whose form launches another kernel than the one beside it, adds
    nothing to the roofline: the pairs that remain read as they would
    alone.  A trace in which no span pairs with a kernel reads nothing."""
    def roofline_of(pairs):
        return pytest.approx(100 * sum(bound_of(GEMMS[i][0]) for i in pairs) / (100e-6 * len(pairs)))

    extra = events() + [kernel("void srgpt::qgemm::w8_large_kernel<false>(CUtensorMap_st)", 1800, 50)]
    assert spans.int8_gemm_roofline(ctx_of(extra)) == roofline_of([0, 1, 2])
    lost = [e for e in events() if e["name"] != GEMMS[0][2]]
    assert spans.int8_gemm_roofline(ctx_of(lost)) == roofline_of([1, 2])
    swapped = [GEMMS[0], (GEMMS[1][0], GEMMS[1][1], GEMMS[2][2], GEMMS[1][3]), GEMMS[2]]
    assert spans.int8_gemm_roofline(ctx_of(events(gemms=swapped))) == roofline_of([0, 2])
    alien = [(name, ts, "void srgpt::qgemm::w8_large_kernel<false>(CUtensorMap_st)", kt) for name, ts, _, kt in GEMMS]
    assert spans.int8_gemm_roofline(ctx_of(events(gemms=alien))) is None


def test_gemm_pairs_step_over_lost_records():
    """One layer's launches (two decode tiles, both kernels, both forms)
    over and over: kernels the trace lost at the slice's head and inside
    it, and a kernel with no span, leave every other span with its own
    kernel."""
    layer = [("k8", "decode", 64), ("k8", "decode", 8), ("k9", "decode", 64), ("k8", "large", 384),
             ("k9", "large", 1024)]
    gemms = [(k, f, M, 4096, 4096, False, False) for _ in range(12) for k, f, M in layer]
    names = [spans._gemm_kernel(g) + ">(CUtensorMap_st)" for g in gemms]
    lost = {0, 1, 2, 31, 32}
    kernels = [n for i, n in enumerate(names) if i not in lost]
    kernels.insert(40, "void srgpt::qgemm::decode_kernel<true, 32>(CUtensorMap_st)")  # no span launches it
    at = [i for i in range(len(names)) if i not in lost]
    at.insert(40, None)
    assert spans.gemm_pairs(gemms, kernels) == [(i, j) for j, i in enumerate(at) if i is not None]
    assert spans.gemm_pairs(gemms, names) == [(i, i) for i in range(len(names))]


def test_the_gemm_bound_takes_the_slower_of_operations_and_bytes():
    M, N, K = 64, 14336, 4096
    nbytes = M * K + N * K + 4 * M + 4 * N + 2 * M * N + 2 * N
    assert spans.gemm_bound_s("k8", M, N, K, False, True) == pytest.approx(nbytes / flops.PEAK_BYTES_S)
    assert spans.gemm_bound_s("k9", 4096, N, K, False, False) == pytest.approx(2 * 4096 * N * K / flops.PEAK["bf16"])


def test_a_traced_small_serving_run_reads_the_engine_spans():
    """A traced run of a small backlog cell on the CPU: the engine's spans
    are in the slice, so the admission share and width read; no kernel
    runs on the CPU, so the idle shares and the roofline are left out."""
    t = dict(small_traffic("region_qa_backlog"), trace_slice={"after_calls": 0, "calls": 3})
    names = [f"{m}.serve" for m in METRICS] + ["roofline.int8_gemm.serve"]
    spec = {"workload": {"name": "small"}, "c": small_config("mixtral-8x7b-w8a8"), "t": t,
            "limits": {"served_gap_mean": 1e9}, "end_to_end": [],
            "per_layer": [{"name": n, "unit": "%"} for n in names]}
    ctx = harness.drive("small", 2**31 + 7, 3.0, True, "cpu", 0.0, spec)
    result, _ = harness.report(ctx)
    assert {"engine.admit", "engine.decode"} <= {n for _, _, n in ctx["timeline"].host}
    assert set(result["metrics"]) == {"admit_share.serve", "admit_width.serve"}
    assert 0 < result["metrics"]["admit_share.serve"]["value"] < 100
    assert 1 <= result["metrics"]["admit_width.serve"]["value"] <= t["admit_width"]
