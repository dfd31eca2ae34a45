"""One run of one cell, driven by data: ``BENCHMARK.json`` names the cell's
configuration, traffic mix and metrics; each is a file of its own under
this folder, found by name:

- ``configs/<config>.json``   the configuration as it is run;
- ``traffic/<mix>.json``      the traffic mix, read by the general driver of
                              its ``kind``, ``<kind>_cell.py`` (``train_cell.py``,
                              ``serve_cell.py``);
- ``limits/<workload>.json``  the limits of the cell's correctness check;
- ``metrics/<metric>.py``     a per-layer metric's reader: ``read(ctx)``
                              returns its value, or None where it finds
                              nothing to read.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str) -> dict:
    """The cell's BENCHMARK.json entries and its files."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise SystemExit(f"unknown workload {workload!r}")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {
        "workload": w, "c": load_json(os.path.join(ROOT, conf["file"])),
        "t": load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        "limits": load_json(os.path.join(HERE, "limits", workload + ".json")),
        "end_to_end": e2e, "per_layer": layer,
    }


def read_metric(name: str, ctx: dict) -> Optional[float]:
    spec = importlib.util.spec_from_file_location("metric_" + name.replace(".", "_"),
                                                  os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(ctx)


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the cell's limits name beside its limit (a reading that
    is not finite fails); the driver's other readings are not compared."""
    return {k: {"value": readings[k], "limit": lim, "ok": bool(math.isfinite(readings[k]) and readings[k] <= lim)}
            for k, lim in limits.items()}


def drive(workload: str, seed: int, seconds: float, trace: bool, device: str, t_start: float, spec: dict) -> dict:
    """One run of the cell ``spec`` by the driver of its traffic's ``kind``,
    ``<kind>_cell.py`` (a new kind is a new file): the run's context, with
    the driver's output under ``out`` and what the check compared under
    ``check``."""
    import torch

    kind = spec["t"]["kind"]
    if not os.path.exists(os.path.join(HERE, kind + "_cell.py")):
        raise SystemExit(f"traffic kind {kind!r} has no driver {kind}_cell.py")
    driver = importlib.import_module(kind + "_cell")
    ctx = {"workload": workload, "seed": int(seed), "seconds": float(seconds), "trace": bool(trace),
           "device": torch.device(device), "t_start": t_start, **spec}
    ctx["out"] = driver.run(ctx)
    return ctx


def report(ctx: dict):
    """(result, notes): the keys of the benchmark's last line, ``checks``
    (each compared number beside its limit) last, and the driver's lines
    for standard error."""
    import torch

    out, trace = ctx["out"], ctx["trace"]
    checks = judge(out["readings"], ctx["limits"])
    if trace:
        metrics = {}
        for m in ctx["per_layer"]:
            value = read_metric(m["name"], ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": ctx["e2e"][m["name"]], "unit": m["unit"]}
                   for m in ctx["end_to_end"] if m["name"] in ctx["e2e"]}
    dev = ctx["device"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": ctx["workload"].get("chips", 1), "memory_peak_bytes": ctx["memory_peak_bytes"]}
    result = {"correct": all(c["ok"] for c in checks.values()), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics, "device": device_info}
    tl = ctx.get("timeline")
    if trace and tl is not None:
        device_info.update(busy_s=tl.busy_s, window_s=tl.window_s)
        result["breakdown"] = {"device_ops": tl.device_ops(), "idle_gaps": tl.idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result, out.get("notes", [])


def run(workload: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        bench: Optional[dict] = None, spec: Optional[dict] = None):
    """``report(drive(...))`` of the cell ``workload``; ``spec`` stands in
    for ``cell(bench, workload)`` (the tests' small cells, a sweep's rate)."""
    spec = spec or cell(bench or load_json(os.path.join(ROOT, "BENCHMARK.json")), workload)
    return report(drive(workload, seed, seconds, trace, device, t_start, spec))


def report_lines(result: dict) -> List[str]:
    """The compared numbers, one a line, for the end of standard error."""
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in result["checks"].items()]
