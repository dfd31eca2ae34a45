"""A traced run of a small serving cell on the CPU: the profiled slice
comes after the calls that the host-clock metrics read, its trace is read
once the window has closed, and the per-layer metrics of the cell are in
the result."""

import harness
from conftest import small_config, small_traffic


def test_a_traced_open_loop_run_reads_its_metrics_from_the_calls_before_the_slice():
    t = dict(small_traffic("region_qa_poisson"), trace_slice={"after_calls": 3, "calls": 2})
    per_layer = [{"name": "engine_step_ms.rate", "unit": "ms"}, {"name": "device_idle_share.rate", "unit": "%"}]
    spec = {"workload": {"name": "small"}, "c": small_config("mistral-7b"), "t": t,
            "limits": {"served_gap": 1e9}, "end_to_end": [], "per_layer": per_layer}
    ctx = harness.drive("small", 2**31 + 41, 3.0, True, "cpu", 0.0, spec)
    result, notes = harness.report(ctx)
    lo, hi = 3, 5
    calls_before = [n for n in notes if n.startswith("traced calls")]
    assert calls_before == [calls_before[0]] and calls_before[0].startswith(f"traced calls {lo}-{hi - 1}:")
    assert ctx["serve"]["decode_steps"] == lo * t["steps_per_call"]
    assert result["metrics"]["engine_step_ms.rate"]["value"] > 0
    assert result["device"]["window_s"] > 0 and "breakdown" in result
    # no kernel runs on the CPU: the idle share has nothing to read and is left out, not 0
    assert "device_idle_share.rate" not in result["metrics"]
