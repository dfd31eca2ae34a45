"""Host and device time of the serving engine's plain decode window on one
card: the eager window against the engine's replays of its one-step CUDA
graph, and against the whole window captured as one graph.

    python3 scripts/bench_decode_graph.py [--out FILE] [--layers 32] [--windows 10]

The decoder is W8A8 with Mixtral-8x7B's depth and routing (32 layers, 8
experts on the dense route, top 2, GQA 4:1, head dim 128, vocabulary
32,000) at narrow widths (hidden 1024, 3584 neurons an expert): the
kernels and launches of a decode step of the full model, at a fraction of
its weights, so the host's launch work is the full model's.  64 slots, the
int8 cache, windows of k = 8, greedy.

One JSON object (also written to FILE when given):

- ``eager``: host ms of the window's call (the launches) and ms to the end
  of its work, the median over ``--windows`` windows;
- ``step_graph``: the same for the engine's window, k replays of its
  one-step graph (``ServingEngine._decode_window``), the seconds of the
  capture and of the graph's first replay (its upload), and the bytes the
  allocator reserved for them;
- ``window_graph``: the same for the k steps captured as one graph here
  (the engine's own ``_decode_once`` k times), replayed once a window;
- ``profiled_replay``: the engine's replayed window under the process's
  first profiler, started after the capture: the kernels the trace holds
  against those of a profiled eager window, and its ``srgpt::qgemm::``
  kernels and K8 / K9 spans against k times the names the capture
  recorded.

Weights and inputs are random from a fixed seed, made on the card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 8


def card() -> dict:
    import torch

    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                               capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = None
    return {"name": torch.cuda.get_device_name(0), "power_limit": limit, "torch": torch.__version__,
            "cuda": torch.version.cuda}


def build(layers: int):
    """(config, model, engine with 64 active slots)."""
    import numpy as np
    import torch

    from spatialrgpt_tpu_torch.config import (LlamaConfig, ProjectorConfig, RegionExtractorConfig,
                                              SiglipVisionConfig, SpatialRGPTConfig)
    from spatialrgpt_tpu_torch.constants import IMAGE_TOKEN_INDEX
    from spatialrgpt_tpu_torch.data.splice import expand_rows
    from spatialrgpt_tpu_torch.models.vlm import VLMInputs
    from spatialrgpt_tpu_torch.serving.engine import ServingEngine
    from spatialrgpt_tpu_torch.utils.weights import init_random_quantized

    cfg = SpatialRGPTConfig(
        llm=LlamaConfig(vocab_size=32000, hidden_size=1024, intermediate_size=3584, num_hidden_layers=layers,
                        num_attention_heads=8, num_key_value_heads=2, num_experts=8, num_experts_per_tok=2,
                        eos_token_id=-1),
        vision=SiglipVisionConfig(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=2,
                                  image_size=56, patch_size=14),
        projector=ProjectorConfig(mm_hidden_size=64, hidden_size=1024),
        region=RegionExtractorConfig(mm_hidden_size=64, hidden_size=1024, ada_pool_size=4),
        mask_token_id=60, depth_token_id=61,
    )
    dev = torch.device("cuda")
    model = init_random_quantized(cfg, dev, w8a8=True, seed=0)
    eng = ServingEngine(model, cfg, num_slots=64, prompt_bucket=32, max_new_tokens=512, kv_quant=True, admit_width=8)
    rng = np.random.default_rng(0)
    for i in range(64):
        ids = [1, IMAGE_TOKEN_INDEX, 60, 61] + list(rng.integers(3, 59, 8 + i % 8))
        sb = expand_rows([np.asarray(ids, np.int64)], None, max_len=64, tokens_per_image=4, mask_token_id=60,
                         depth_token_id=61, regions_per_image=2, pad_to=32)
        x = VLMInputs.from_spliced(sb, rng.standard_normal((1, 56, 56, 3)), rng.standard_normal((1, 56, 56, 3)),
                                   (rng.random((1, 2, 56, 56)) > 0.5).astype(np.float32), np.ones((1, 2), bool),
                                   device=dev, dtype=torch.bfloat16)
        eng.submit(x, int(sb.segment_ids.sum()), max_new_tokens=512)
    eng._graph_window = False
    eng.step(K)  # the admissions and one eager window
    torch.cuda.synchronize()
    assert eng.active.all()
    return cfg, model, eng


def timed(fn, n: int) -> dict:
    """Median host ms of ``fn()``'s call and ms to the end of its work."""
    import torch

    host, total = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append(1e3 * (t1 - t0))
        total.append(1e3 * (t2 - t0))
    return {"host_ms": statistics.median(host), "total_ms": statistics.median(total), "host_ms_all": host,
            "total_ms_all": total}


def first_use(eng) -> dict:
    """The engine's first greedy window (eager) and the capture of its step,
    timed apart, then the graph's first replay (its upload), and the bytes
    reserved."""
    import torch

    stats = torch.cuda.memory_stats()
    capture, seconds = eng._capture, {}

    def capture_timed(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        capture(*args)
        torch.cuda.synchronize()
        seconds["capture_s"] = time.perf_counter() - t0

    eng._capture = capture_timed
    eng._decode_window(K, True, *eng._sched)
    del eng._capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._decode_window(K, True, *eng._sched)
    torch.cuda.synchronize()
    seconds["first_replay_s"] = time.perf_counter() - t0
    seconds["reserved_bytes"] = torch.cuda.memory_stats()["reserved_bytes.all.current"] - \
        stats["reserved_bytes.all.current"]
    seconds["qgemm_launches_a_step"] = len(eng._graphs[True][2])
    return seconds


def window_graph(eng):
    """(the k steps captured as one graph, seconds of its capture, of its
    first replay, bytes reserved)."""
    import torch

    stats = torch.cuda.memory_stats()
    out = torch.empty((eng.B, K), dtype=torch.int64, device=eng.device)
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=eng._graph_pool)
        for i in range(K):
            out[:, i] = eng._decode_once(*eng._sched, True)
        graph.capture_end()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    graph.replay()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return graph, {"capture_s": t1 - t0, "first_replay_s": t2 - t1, "reserved_bytes":
                   torch.cuda.memory_stats()["reserved_bytes.all.current"] - stats["reserved_bytes.all.current"]}


def kernels_of(fn) -> dict:
    """Kernels in the profiler's trace of ``fn()``: all, and srgpt::qgemm::."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
    spans = [e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith(("k8.", "k9."))]
    return {"kernels": len(kernels), "qgemm_kernels": sum("srgpt::qgemm::" in n for n in kernels),
            "qgemm_spans": len(spans)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out")
    p.add_argument("--layers", type=int, default=32)
    p.add_argument("--windows", type=int, default=10)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    _, _, eng = build(args.layers)
    out = {"card": card(), "layers": args.layers, "slots": eng.B, "k": K}
    out["eager"] = timed(lambda: eng._decode_window(K, True, *eng._sched), args.windows)
    eng._graph_window = True
    out["step_graph"] = first_use(eng)
    out["step_graph"].update(timed(lambda: eng._decode_window(K, True, *eng._sched), args.windows))
    graph, out["window_graph"] = window_graph(eng)
    out["window_graph"].update(timed(graph.replay, args.windows))
    del graph
    replay = kernels_of(lambda: eng._decode_window(K, True, *eng._sched))
    names = eng._graphs.pop(True)[2]
    eng._graph_window = False
    eager = kernels_of(lambda: eng._decode_window(K, True, *eng._sched))
    out["profiled_replay"] = {"replay": replay, "eager": eager, "recorded_names_a_window": K * len(names)}
    out["graph_stats"] = eng.graph_stats
    line = json.dumps(out)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
