"""The driver of ``kind: serve`` traffic: region-QA requests through the
port's ``ServingEngine`` (``submit`` / ``step``), greedy, each request's
answer length drawn by the traffic (eos ignored).

- ``loop: closed``: ``clients`` clients each keep one request in flight,
  so more requests wait than there are slots (a backlog);
- ``loop: open``: requests arrive on a schedule at ``rate_per_s``,
  whatever the engine does: Poisson-like arrivals whose every block of
  ``arrival_block_s`` seconds holds rate x block gaps, the exponential
  distribution's quantiles, in an order drawn from the seed (every seed's
  window has the same gaps and count; where its bursts fall differs).

Set-up builds the model and engine and warms every admission width up
(``warmup``: 8 + 4 + 2 + 1 requests, each batch a power of 2) and the
decode step.  In the closed loop it then submits the clients' first
requests and runs ``prime_calls`` calls, so the window starts on full
slots and a queue; only the tokens that reach the host inside the window
count.  The open loop's window starts on an empty engine.  A request's first
token counts from the ``step`` call that returned it; in the open loop its
time to first token runs from its scheduled arrival.  A traced run
profiles ``trace_slice["calls"]`` calls after the first
``trace_slice["after_calls"]``; its host-clock readings come from the calls
before the slice, where nothing of the profiler runs.  After the window a
sample of the finished requests, the longest among them, is checked
against the plain reference.

``engine`` holds further keyword arguments of ``ServingEngine`` (such as
``prefill_chunk``), passed as they are.
"""

from __future__ import annotations

import gc
import math
import os
import time
from typing import List

import numpy as np
import torch

import checks
import flops
import program
import seeded
import timeline
import window
from harness import ROOT
from train_cell import free, quiet_gc, sync


class Stream:
    """Request i of a seed's traffic: its prompt, answer length, image slot
    and boxes."""

    def __init__(self, c: dict, t: dict, seed: int, salt: int, n: int = 1 << 14):
        rng = np.random.default_rng([int(seed), salt])
        self.c, self.t, self.seed, self.salt = c, t, int(seed), salt
        self.n_text = seeded.deck(rng, t["text_tokens"]["low"], t["text_tokens"]["high"], n)
        self.n_out = seeded.deck(rng, t["output_tokens"]["low"], t["output_tokens"]["high"], n)
        self.slot = rng.integers(0, t["image_pool"], n)
        self.boxes = seeded.draw_boxes(rng, n, t["regions"], c["vision"]["image_size"], t["box_side"]["low"],
                                       t["box_side"]["high"])
        if t["loop"] == "open":
            k = round(t["rate_per_s"] * t["arrival_block_s"])  # a block's gaps: the exponential's quantiles
            quantiles = -np.log(1 - (np.arange(k) + 0.5) / k) / t["rate_per_s"]
            gaps = np.concatenate([rng.permutation(quantiles) for _ in range(-(-n // k))])[:n]
            self.arrival = np.cumsum(gaps)

    def ids(self, i: int) -> List[int]:
        rng = np.random.default_rng([self.seed, self.salt, i])
        return seeded.prompt_ids(self.c, rng, int(self.n_text[i]), self.t["regions"])


class Record:
    __slots__ = ("i", "rid", "req", "plen", "n_out", "due", "sent", "first", "done", "ids")

    def __init__(self, i, rid, req, plen, n_out, due, sent, ids):
        self.i, self.rid, self.req, self.plen, self.n_out, self.ids = i, rid, req, plen, n_out, ids
        self.due, self.sent = due, sent
        self.first = self.done = None


def run(ctx: dict) -> dict:
    c, t, seed, dev = ctx["c"], ctx["t"], ctx["seed"], ctx["device"]
    k = t["steps_per_call"]
    program.load_kernels(dev)
    pcfg = program.port_config(c, ignore_eos=t["ignore_eos"],
                               max_length=max(4096, t["prompt_bucket"] + t["output_tokens"]["high"]))
    model = program.build_model(pcfg, c, seeded.make_weights(c, seed, dev))
    eng = program.make_engine(model, pcfg, t)
    S, R = c["vision"]["image_size"], t["regions"]
    images = seeded.pixels(seed, t["image_pool"], S, dev, 0)
    depths = seeded.pixels(seed, t["image_pool"], S, dev, 1)

    def submit(stream: Stream, i: int, due: float, max_new: int = 0, t0: float = 0.0) -> Record:
        slot = int(stream.slot[i])
        masks = seeded.box_masks(torch.as_tensor(stream.boxes[i : i + 1], device=dev), S).to(torch.bfloat16)
        ids = stream.ids(i)
        inputs, plen = program.serve_request(pcfg, ids, t["prompt_bucket"], images[slot : slot + 1],
                                             depths[slot : slot + 1], masks)
        n_out = max_new or int(stream.n_out[i])
        rid = eng.submit(inputs, plen, max_new_tokens=n_out)
        return Record(i, rid, eng.queue[-1], plen, n_out, due, time.perf_counter() - t0, ids)

    warm = Stream(c, t, seed, salt=3)
    for i in range(t["warmup"]["requests"]):
        submit(warm, i, 0.0, t["warmup"]["output_tokens"])
    eng.run_until_drained(num_steps=k)
    sync(dev)

    stream = Stream(c, t, seed, salt=2)
    open_loop = t["loop"] == "open"
    recs, by_rid, calls = [], {}, []
    nxt = 0
    slice_at, slice_calls = (t["trace_slice"]["after_calls"], t["trace_slice"]["calls"]) if ctx["trace"] else (-1, 0)
    snap, sl = {}, None
    t0 = time.perf_counter()

    def add(due):
        nonlocal nxt
        r = submit(stream, nxt, due, t0=t0)
        recs.append(r)
        by_rid[r.rid] = r
        nxt += 1

    if not open_loop:  # the clients' first requests, and calls until the slots are full: a backlog from t0
        for _ in range(t["clients"]):
            add(0.0)
        for _ in range(t["prime_calls"]):
            for done in eng.step(k):
                by_rid[done.request_id].done = -1.0
                add(0.0)
        sync(dev)
    start = {r.rid: len(r.req.tokens) for r in recs}
    quiet_gc()
    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    while True:
        now = time.perf_counter() - t0
        if open_loop:
            while stream.arrival[nxt] <= now:
                add(float(stream.arrival[nxt]))
        if now >= ctx["seconds"]:
            break
        if not eng.queue and not eng.active.any():
            if not open_loop:
                break
            time.sleep(max(0.0, min(stream.arrival[nxt], ctx["seconds"]) - now))
            continue
        if len(calls) == slice_at and sl is None:
            snap["before"] = {r.rid: len(r.req.tokens) for r in recs}
            sl = timeline.Slice(os.path.join(ROOT, "build", "bench", "trace.json"))
            sl.start()
        a = time.perf_counter() - t0
        finished = eng.step(k)
        b = time.perf_counter() - t0
        calls.append((a, b, k))
        for r in recs:
            if r.first is None and r.req.tokens:
                r.first = b
        for done in finished:
            by_rid[done.request_id].done = b
            if not open_loop and b < ctx["seconds"]:
                add(b)
        if sl is not None and "after" not in snap and (len(calls) == slice_at + slice_calls
                                                         or b >= ctx["seconds"]):
            sl.stop()
            snap["after"] = {r.rid: len(r.req.tokens) for r in recs}
            snap["calls"] = (slice_at, len(calls))
        if b >= ctx["seconds"]:
            break
    sync(dev)
    gc.unfreeze()
    span = max(ctx["seconds"], calls[-1][1] if calls else 0.0)
    tokens = sum(len(r.req.tokens) - start.get(r.rid, 0) for r in recs)
    ctx["e2e"] = {"serve_tokens_per_s": tokens / span, "setup_s": setup_s}
    notes = [f"window {span:.3f} s: {len(recs)} requests submitted, {sum(r.done is not None and r.done >= 0 for r in recs)} "
             f"finished, {len(eng.queue)} queued at its end, {tokens} tokens, {len(calls)} step calls; the longest "
             f"calls (start s, wall s): {sorted(((round(a, 3), round(b - a, 3)) for a, b, _ in calls), key=lambda x: -x[1])[:3]}"]
    if open_loop:
        due = [r for r in recs if r.due <= ctx["seconds"]]
        ttft = [r.first - r.due if r.first is not None and r.first <= span else math.inf for r in due]
        ctx["e2e"]["ttft_p95_s"] = window.percentile(ttft, 95)
        late = max((r.sent - r.due for r in due), default=0.0)
        notes.append(f"ttft over {len(ttft)} requests due in the window: p50 {window.percentile(ttft, 50)!r} s, "
                     f"p95 {ctx['e2e']['ttft_p95_s']!r} s, missing {sum(math.isinf(x) for x in ttft)}; "
                     f"the generator ran at most {late:.4f} s late")
    if sl is not None:  # the window has closed: the trace is exported and read now
        ctx["timeline"] = sl.timeline()
        ctx["serve"] = serve_facts(c, t, recs, calls, snap, start)
        lo, hi = snap["calls"]
        notes.append(f"traced calls {lo}-{hi - 1}: {calls[hi - 1][1] - calls[lo][0]:.3f} s; the {lo} calls before "
                     f"them: {sum(b - a for a, b, _ in calls[:lo]):.3f} s of {calls[lo - 1][1] if lo else 0.0:.3f}")
    attempted = len(recs)
    ctx["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the check: a sample of the finished requests drawn from the seed, the longest in it
    finished = [r for r in recs if r.done is not None and r.done >= 0]
    rng = np.random.default_rng([int(seed), 4])
    longest = max(finished, key=lambda r: (len(r.req.tokens), -r.i))
    others = [r for r in finished if r is not longest]
    n = min(t["check"]["requests"], len(finished)) - 1
    sample = [longest] + [others[j] for j in sorted(rng.choice(len(others), n, replace=False))]
    reqs = [{"ids": r.ids, "tokens": list(r.req.tokens), "image": images[int(stream.slot[r.i])],
             "depth": depths[int(stream.slot[r.i])],
             "masks": seeded.box_masks(torch.as_tensor(stream.boxes[r.i], device=dev), S)} for r in sample]
    del eng, model, recs, by_rid, finished, others, sample, longest

    from reference import model as ref_model
    from reference import serve as ref_serve

    ref_model.plain_precision()
    t_ref = time.perf_counter()
    freed = free(dev)
    W = seeded.make_weights(c, seed, dev)
    gaps = ref_serve.gaps(c, W, reqs)
    del W
    free(dev)
    readings = checks.served_readings(gaps["served"])
    ctx["check"] = {"requests": reqs}
    notes.append(f"checked {len(reqs)} requests, {sum(len(r['tokens']) for r in reqs)} served tokens; the "
                 f"program's state freed: {freed}; the reference took {time.perf_counter() - t_ref:.1f} s")
    return {"readings": readings, "attempted": attempted, "failed": 0, "notes": notes}


def serve_facts(c: dict, t: dict, recs: List[Record], calls: list, snap: dict, start: dict) -> dict:
    """What the per-layer readers of a traced run need: the model
    operations of the window's calls before the traced slice and their
    wall from the window's start, those calls' summed wall and decode
    steps (nothing of the profiler runs there), and the K3 keys that the
    slice's decode steps read."""
    lo, _ = snap["calls"]
    before, after = snap["before"], snap["after"]

    def ops_of(r: Record, a: int, b: int) -> flops.Ops:
        """Operations of tokens a..b-1 of request r (0: its admission)."""
        total = flops.Ops()
        for i in range(a, b):
            total = total + (flops.prefill_ops(c, r.plen, t["regions"]) if i == 0 else flops.decode_ops(c, r.plen + i))
        return total

    ops, k3_keys = flops.Ops(), 0
    for r in recs:
        a, b = before.get(r.rid, 0), after.get(r.rid, before.get(r.rid, 0))
        ops = ops + ops_of(r, start.get(r.rid, 0), a)
        k3_keys += sum(r.plen + i for i in range(max(a, 1), b))
    return {
        "ops_before_slice": ops, "wall_before_slice": calls[lo - 1][1] if lo else 0.0,
        "call_wall": sum(b - a for a, b, _ in calls[:lo]), "decode_steps": sum(k for _, _, k in calls[:lo]),
        "k3_keys_slice": k3_keys * c["num_hidden_layers"], "slots": t["slots"],
    }
