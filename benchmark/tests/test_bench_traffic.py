"""The traffic mixes: the same seed gives the same inputs, another seed
the same sizes in another order, and every draw lies in its stated range."""

import numpy as np
import torch

import seeded
import serve_cell
import train_cell
from conftest import small_config, small_traffic


def test_serve_stream_is_deterministic_and_in_range():
    c, t = small_config("mixtral-8x7b-w8a8"), small_traffic("region_qa_backlog")
    a, b, other = (serve_cell.Stream(c, t, s, salt=2, n=400) for s in (2**31 + 11, 2**31 + 11, 5))
    assert np.array_equal(a.n_text, b.n_text) and np.array_equal(a.n_out, b.n_out)
    assert np.array_equal(a.boxes, b.boxes) and a.ids(7) == b.ids(7)
    assert not np.array_equal(a.n_out, other.n_out)
    span = t["output_tokens"]["high"] - t["output_tokens"]["low"] + 1
    assert sorted(a.n_out[:span]) == sorted(other.n_out[:span])  # one deck: the same sizes
    assert a.n_text.min() >= t["text_tokens"]["low"] and a.n_text.max() <= t["text_tokens"]["high"]
    assert a.n_out.min() >= t["output_tokens"]["low"] and a.n_out.max() <= t["output_tokens"]["high"]
    size = c["vision"]["image_size"]
    w = a.boxes[..., 2:] - a.boxes[..., :2]
    assert (a.boxes >= 0).all() and (a.boxes[..., 2:] <= size).all()
    assert w.min() >= t["box_side"]["low"] and w.max() <= t["box_side"]["high"]
    ids = a.ids(3)
    assert ids[:2] == [c["bos_token_id"], seeded.IMAGE_TOKEN] and len(ids) == 2 + 2 * t["regions"] + a.n_text[3]
    assert all(3 <= x < c["vocab_size"] for x in ids[2 + 2 * t["regions"]:])


def test_open_loop_arrivals_hold_the_rate():
    c, t = small_config("mistral-7b"), small_traffic("region_qa_poisson")
    t = dict(t, rate_per_s=8.0, arrival_block_s=10)
    k = 80  # gaps a block
    a, b = serve_cell.Stream(c, t, 9, salt=2, n=4 * k), serve_cell.Stream(c, t, 2**31 + 10, salt=2, n=4 * k)
    assert np.all(np.diff(a.arrival) > 0)
    for x, y in ((a, b), (a, a)):  # every block: the same gaps, in another order
        assert np.allclose(x.arrival[k - 1 :: k], y.arrival[k - 1 :: k])
    assert abs(k / a.arrival[k - 1] - 8.0) < 0.5 and abs(a.arrival[k - 1] - 10.0) < 0.5
    # arrivals in each second of a block vary as a Poisson count does, and not alike for two seeds
    per_s = [np.histogram(s.arrival[:k], bins=10, range=(0, 10))[0] for s in (a, b)]
    assert per_s[0].std() > 1.0 and per_s[1].std() > 1.0 and not np.array_equal(per_s[0], per_s[1])
    same = serve_cell.Stream(c, t, 9, salt=2, n=4 * k)
    assert np.array_equal(a.arrival, same.arrival)


def test_train_batches_are_deterministic_packed_and_in_range():
    c, t = small_config("mistral-7b"), small_traffic("align_4x4096")
    dev = torch.device("cpu")
    a, b = train_cell.batches(c, t, 123, dev, 2), train_cell.batches(c, t, 123, dev, 2)
    for x, y in zip(a, b):
        assert [s["ids"] for s in x["samples"]] == [s["ids"] for s in y["samples"]]
        assert torch.equal(x["images"], y["images"]) and torch.equal(x["masks"], y["masks"])
    lens = [[s["length"] for s in x["samples"]] for x in a]
    assert sorted(lens[0]) == sorted(lens[1]) and lens[0] != [s["ids"] for s in a[1]["samples"]]
    lo, hi = t["sample_positions"]["low"], t["sample_positions"]["high"]
    assert min(lens[0]) >= lo and max(lens[0]) <= hi
    for row in a[0]["rows"]:
        assert row["segment_ids"].max() == t["samples_per_row"]
        assert int((row["segment_ids"] > 0).sum()) <= t["seq"]
        assert int(row["is_image"].sum()) == t["samples_per_row"] * train_cell.tokens_per_image(c)
        assert int(row["is_mask"].sum()) == int(row["is_depth"].sum()) == t["samples_per_row"] * t["regions"]
    assert not torch.equal(a[0]["images"], a[1]["images"])  # every step's rows differ
