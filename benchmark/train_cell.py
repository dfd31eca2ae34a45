"""The driver of ``kind: train`` traffic: the align step of the port
(``train/step.py``) on packed rows of region-QA samples.

Set-up builds the model from the seed's weights and one train state, and
drives that state through the check's first steps (which also warm every
shape up: each step has the same shapes).  The window then runs whole
steps on the same state until ``--seconds`` is up, each ending on the
host's read of its loss.  After the window the program's state is freed
and the plain reference follows the first steps on the same batches.
"""

from __future__ import annotations

import gc
import math
import os
import time
from typing import Dict, List

import numpy as np
import torch

import checks
import flops
import program
import seeded
import timeline
from harness import ROOT


def tokens_per_image(c: dict) -> int:
    return ((c["region"]["ada_pool_size"] + 1) // 2) ** 2


def expand_row(c: dict, samples: List[dict], seq: int, regions: int) -> Dict[str, np.ndarray]:
    """The port's packed-row fields of ``samples`` (each its own segment,
    positions from 0, its image's tokens and regions by its image number)."""
    T = tokens_per_image(c)
    row = {k: np.zeros(seq, np.int64) for k in ("input_ids", "image_gather_idx", "position_ids", "segment_ids",
                                                 "mask_slot", "depth_slot")}
    row.update({k: np.zeros(seq, bool) for k in ("is_image", "is_mask", "is_depth")})
    row["labels"] = np.full(seq, seeded.IGNORE, np.int64)
    off = 0
    for j, s in enumerate(samples):
        img, n_mask, n_depth, p = s["image"], 0, 0, off
        for tok in s["ids"]:
            if tok == seeded.IMAGE_TOKEN:
                row["is_image"][p : p + T] = True
                row["image_gather_idx"][p : p + T] = img * T + np.arange(T)
                p += T
                continue
            row["input_ids"][p] = tok
            if tok == c["mask_token_id"]:
                row["is_mask"][p], row["mask_slot"][p] = True, img * regions + n_mask
                n_mask += 1
            elif tok == c["depth_token_id"]:
                row["is_depth"][p], row["depth_slot"][p] = True, img * regions + n_depth
                n_depth += 1
            p += 1
        n = p - off
        row["position_ids"][off:p] = np.arange(n)
        row["segment_ids"][off:p] = j + 1
        row["labels"][off:p] = s["labels"]
        off = p
    return row


def batches(c: dict, t: dict, seed: int, device, n: int) -> List[dict]:
    """``n`` distinct batches of the mix: ``rows`` packed rows of
    ``samples_per_row`` samples (bos, the image, regions x (<mask>,
    <depth>), a question), the samples' lengths the same multiset in every
    batch, each sample with its own image, depth map and box regions."""
    rng = np.random.default_rng([int(seed), 1])
    R, S, spr = t["regions"], c["vision"]["image_size"], t["samples_per_row"]
    n_s = t["rows"] * spr
    head = 1 + tokens_per_image(c) + 2 * R
    out = []
    for b in range(n):
        samples = []
        for j, L in enumerate(seeded.spread(rng, t["sample_positions"]["low"], t["sample_positions"]["high"], n_s)):
            ids = seeded.prompt_ids(c, rng, int(L) - head, R)
            labels = [seeded.IGNORE] * head + ids[2 + 2 * R :]
            samples.append({"ids": ids, "labels": labels, "image": j, "length": int(L)})
        boxes = seeded.draw_boxes(rng, n_s, R, S, t["box_side"]["low"], t["box_side"]["high"])
        out.append({
            "samples": samples,
            "rows": [expand_row(c, samples[r * spr : (r + 1) * spr], t["seq"], R) for r in range(t["rows"])],
            "images": seeded.pixels(seed, n_s, S, device, 2 * b),
            "depths": seeded.pixels(seed, n_s, S, device, 2 * b + 1),
            "masks": seeded.box_masks(torch.as_tensor(boxes, device=device), S).to(torch.bfloat16),
        })
    return out


def run(ctx: dict) -> dict:
    c, t, seed, dev = ctx["c"], ctx["t"], ctx["seed"], ctx["device"]
    s = t["step"]
    program.load_kernels(dev)
    pcfg = program.port_config(c, max_length=t["seq"])
    trained_dtype = getattr(torch, s["trained_dtype"])
    W = seeded.make_weights(c, seed, dev, trained_dtype=trained_dtype)
    trained = [n for n in W if n.startswith(tuple(m + "." for m in s["tuned"]))]
    for n in trained:  # leaves of their own for the optimizer
        W[n] = W[n].clone()
    model = program.build_model(pcfg, c, W)
    del W
    pool = batches(c, t, seed, dev, t["distinct_batches"])
    inputs = [program.train_inputs(b["rows"], b["images"], b["depths"], b["masks"], dev) for b in pool]
    state, step = program.train_step(model, pcfg, c, t)
    params = dict(model.named_parameters())
    start = {n: params[n].detach().float().clone() for n in trained}
    n_check = t["check"]["steps"]
    prog = {"loss": []}
    for i in range(n_check):
        state, m = step(state, inputs[i])
        prog["loss"].append(float(m["loss"]))
        if i == 0:
            prog["grad1"] = {n: float(program.adam_first_moment(state, n).float().norm()) / (1 - s["adam_b1"])
                             for n in trained}
    prog["change"] = {n: float((params[n].detach().float() - start[n]).norm()) for n in trained}
    del start
    sync(dev)
    quiet_gc()

    t0 = time.perf_counter()
    setup_s = t0 - ctx["t_start"]
    record, i, traced, sl = [], n_check, None, None
    while True:
        a = time.perf_counter()
        if ctx["trace"] and len(record) == 1:  # the window's second step, profiled
            traced, sl = len(record), timeline.Slice(os.path.join(ROOT, "build", "bench", "trace.json"))
            sl.start()
        state, m = step(state, inputs[i % len(inputs)])
        loss = float(m["loss"])
        if traced == len(record):
            sl.stop()
        i += 1
        record.append((a, time.perf_counter(), loss))
        if record[-1][1] - t0 >= ctx["seconds"]:
            break
    window = record[-1][1] - t0
    if sl is not None:  # the window has closed: the trace is exported and read now
        ctx["timeline"] = sl.timeline()
    lengths = [x["length"] for x in pool[0]["samples"]]
    live = sum(lengths)
    ctx["e2e"] = {"train_tokens_per_s": live * len(record) / window, "setup_s": setup_s}
    untraced = [r for k, r in enumerate(record) if k != traced]
    ctx["train"] = {"step_ops": flops.train_step_ops(c, lengths, t["regions"]), "steps": len(untraced),
                    "wall": sum(b - a for a, b, _ in untraced),
                    "k4_bounds": flops.k4_bounds(c, t["rows"], t["seq"], lengths)}
    ctx["memory_peak_bytes"] = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = sum(not math.isfinite(r[2]) for r in record)
    gc.unfreeze()
    del state, step, model, params, inputs, m
    freed = free(dev)

    from reference import model as ref_model
    from reference import train as ref_train

    ref_model.plain_precision()
    t_ref = time.perf_counter()
    W = seeded.make_weights(c, seed, dev, trained_dtype=trained_dtype)
    ref = ref_train.follow(c, W, trained, pool[:n_check], s)
    del W
    free(dev)
    readings = checks.train_readings(prog, ref)
    ctx["check"] = {"trained": trained, "batches": pool[:n_check], "ref": ref, "trained_dtype": trained_dtype}
    notes = [f"losses program {prog['loss']} reference {ref['loss']}",
             f"window: {len(record)} steps in {window:.3f} s, {live} live positions a step",
             f"the program's state freed: {freed}; the reference took {time.perf_counter() - t_ref:.1f} s"]
    return {"readings": readings, "attempted": len(record), "failed": failed, "notes": notes}


def quiet_gc() -> None:
    """Collect once and move every object set-up made out of the
    collector's reach, so that its passes in the window walk only what the
    window makes (``gc.unfreeze`` after the window)."""
    gc.collect()
    gc.freeze()


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def free(dev) -> str:
    """Collect what nothing holds any more and give the card's cached
    blocks back; returns the allocated and reserved GiB after."""
    gc.collect()
    if dev.type != "cuda":
        return ""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB allocated, " \
           f"{torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB reserved"
