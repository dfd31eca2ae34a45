"""The benchmark's own tests: its modules import as top-level names, as
``run.py`` imports them; small cells that drive a whole run on the CPU."""

import copy
import json
import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def small_config(name: str) -> dict:
    """A configuration file of the benchmark at toy widths (the CPU's)."""
    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        c = json.load(f)
    c.update(vocab_size=256, hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, mask_token_id=256, depth_token_id=257)
    if c.get("num_local_experts"):
        c["num_local_experts"] = 4
    c["vision"] = dict(c["vision"], hidden_size=32, intermediate_size=48, num_hidden_layers=3,
                       num_attention_heads=2, image_size=28)
    return c


def small_traffic(name: str) -> dict:
    with open(os.path.join(BENCH, "traffic", name + ".json")) as f:
        t = json.load(f)
    if t["kind"] == "train":
        t.update(rows=2, seq=512, samples_per_row=2, sample_positions={"low": 220, "high": 250}, distinct_batches=3,
                 box_side={"low": 4, "high": 20})
        t["step"] = dict(t["step"], ce_chunk=256)
    else:
        t.update(clients=6, slots=4, prompt_bucket=256, steps_per_call=2, text_tokens={"low": 8, "high": 16},
                 output_tokens={"low": 2, "high": 6}, image_pool=4, box_side={"low": 4, "high": 20},
                 warmup={"requests": 3, "output_tokens": 2}, check={"requests": 3})
        if t["loop"] == "open":
            t["rate_per_s"] = 4.0
    return t


@pytest.fixture
def small_cell():
    """small_cell(config, traffic, limits) -> the spec ``harness.run`` takes."""

    def make(config: str, traffic: str, limits: dict) -> dict:
        return {"workload": {"name": "small"}, "c": small_config(config), "t": small_traffic(traffic),
                "limits": copy.deepcopy(limits), "end_to_end": [], "per_layer": []}

    return make
