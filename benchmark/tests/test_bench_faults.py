"""The correctness check sees a broken timed path: a whole run of a small
cell on the CPU (the look for a chip skipped), once sound, then with a
fault planted in the port underneath, must come out not correct under
limits set a little above the sound run's readings."""

import pytest
import torch

import harness

TRAIN_LIMITS = {"loss_gap": 1.0, "grad_gap": 1.0, "change_gap": 1.0}
FLOOR = {"served_gap": 0.05, "served_gap_mean": 0.01}  # a sound small run may read 0


def run(spec, seed=2**31 + 5):
    result, _ = harness.run("small", seed, 0.5, False, "cpu", 0.0, spec=spec)
    return result


def limits_above(result):
    return {k: max(3 * c["value"], FLOOR.get(k, 1e-3)) for k, c in result["checks"].items()}


@pytest.fixture
def train_spec(small_cell):
    sound = run(small_cell("mistral-7b", "align_4x4096", TRAIN_LIMITS))
    assert sound["correct"]
    return small_cell("mistral-7b", "align_4x4096", limits_above(sound))


def test_a_step_that_leaves_the_state_unchanged_is_caught(train_spec, monkeypatch):
    from spatialrgpt_tpu_torch.train import optimizer

    monkeypatch.setattr(optimizer.AdamW, "step", lambda self, closure=None: None)
    got = run(train_spec)
    assert not got["correct"]
    assert got["checks"]["change_gap"]["value"] > 0.9


def test_half_the_batch_left_out_is_caught(train_spec, monkeypatch):
    from spatialrgpt_tpu_torch.models import vlm

    whole = vlm.loss_fn

    def half(model, cfg, inputs, **kw):
        rows = inputs.input_ids.shape[0] // 2
        cut = inputs._replace(**{f: getattr(inputs, f)[:rows] for f in (
            "input_ids", "is_image", "image_gather_idx", "position_ids", "segment_ids", "labels", "mask_slot",
            "is_mask", "depth_slot", "is_depth")})
        return whole(model, cfg, cut, **kw)

    monkeypatch.setattr(vlm, "loss_fn", half)
    assert not run(train_spec)["correct"]


@pytest.mark.parametrize("config", ["mistral-7b", "mixtral-8x7b-w8a8"])
def test_a_token_altered_where_it_is_produced_is_caught(small_cell, monkeypatch, config):
    sound = run(small_cell(config, "region_qa_backlog", {"served_gap": 1e9, "served_gap_mean": 1e9}))
    spec = small_cell(config, "region_qa_backlog", limits_above(sound))
    from spatialrgpt_tpu_torch.serving import engine

    right = engine.sample_tokens

    def altered(logits, *args, **kw):
        return (right(logits, *args, **kw) + 1) % logits.shape[-1]

    monkeypatch.setattr(engine, "sample_tokens", altered)
    got = run(spec)
    assert not got["correct"] and all(c["value"] > c["limit"] for c in got["checks"].values())
