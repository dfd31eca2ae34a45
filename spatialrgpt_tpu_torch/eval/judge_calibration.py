"""Calibration harness for the offline judge (VERDICT round-1 weak #5).

The reference scores SpatialRGPT-Bench with GPT-4 as the judge
(llava/eval/gpt_eval*.py); our deterministic ``LocalExtractor`` stands in
for it offline.  Two calibration surfaces:

1. An authored gold set (``CALIBRATION_SET``, 80 entries — r5 doubled it
   with adversarial phrasings drawn from the round-4 paraphrase banks)
   of phrasing variants per category — comparatives, synonyms, number
   words, unit mixes, yes/no framings, subject-inverted clauses
   ("[B] towers over [A]"), former/latter references, word negations,
   and the banks' affirm/negate openers — each with an unambiguous gold
   mark.  ``calibrate()`` reports per-category agreement of any
   extractor against gold; ``tests/test_eval.py`` gates LocalExtractor
   at >= 0.95 overall so extractor regressions are caught.  Coverage
   note: the gate exercises every qualitative pair, all five
   quantitative categories, and clock directions; it does NOT cover
   free-form hedged prose with no side word or polarity opener (those
   fall to exact-match and are the residual LocalExtractor-vs-GPT4 gap
   that ``agreement_with_recorded`` exists to quantify online).
2. ``agreement_with_recorded()`` diffs LocalExtractor marks against a
   jsonl of *recorded* GPT-4 judgments (producible online with
   GPT4Extractor; schema {"category", "question", "answer", "response",
   "mark"}), so a single online run yields the LocalExtractor-vs-GPT4
   agreement table that makes offline scores interpretable.

The port's own copy of ``spatialrgpt_tpu/eval/judge_calibration.py``.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional

# Each entry: category (bench category string), answer = ground-truth
# phrasing, response = model phrasing to be judged, gold = 1 (agrees)
# or 0 (disagrees).  Quantitative entries instead carry gt_m / gold_m
# (expected parsed meters for answer/response; None = unparseable).
CALIBRATION_SET: List[Dict] = [
    # --- left/right ---
    dict(category="left_right", answer="Region [0] is to the left of Region [1].", response="The first region is on the left.", gold=1),
    dict(category="left_right", answer="Region [0] is to the left of Region [1].", response="It is positioned to the right of Region [1].", gold=0),
    dict(category="left_right", answer="No, it is to the right.", response="No. Region [0] is right of Region [1].", gold=1),
    dict(category="left_right", answer="Yes, [A] is to the left of [B].", response="Yes, it is.", gold=1),
    dict(category="left_right", answer="Yes, [A] is to the left of [B].", response="No.", gold=0),
    # --- tall/short (comparatives) ---
    dict(category="tall_short", answer="Region [0] is taller than Region [1].", response="The first object is taller.", gold=1),
    dict(category="tall_short", answer="Region [0] is taller than Region [1].", response="Region [0] is shorter than Region [1].", gold=0),
    dict(category="tall_short", answer="[A] is shorter.", response="It is not as tall as the other one; the shorter one is [A].", gold=1),
    # --- below/above (synonyms: under/over, beneath) ---
    dict(category="below_above", answer="Region [0] is below Region [1].", response="It sits beneath Region [1].", gold=1),
    dict(category="below_above", answer="Region [0] is below Region [1].", response="Region [0] is under the shelf.", gold=1),
    dict(category="below_above", answer="Region [0] is above Region [1].", response="It is positioned over the table, above Region [1].", gold=1),
    dict(category="below_above", answer="Region [0] is above Region [1].", response="It is below.", gold=0),
    # --- behind/front ---
    dict(category="behind_front", answer="Region [0] is behind Region [1].", response="The chair is at the back, behind the desk.", gold=1),
    dict(category="behind_front", answer="Region [0] is in front of Region [1].", response="It stands in front of the sofa.", gold=1),
    dict(category="behind_front", answer="Region [0] is in front of Region [1].", response="It is behind the sofa.", gold=0),
    # --- big/small (comparatives: larger/smaller) ---
    dict(category="big_small", answer="Region [0] is bigger than Region [1].", response="The first one is larger.", gold=1),
    dict(category="big_small", answer="Region [0] is smaller.", response="Region [0] is the smaller of the two.", gold=1),
    dict(category="big_small", answer="Region [0] is bigger than Region [1].", response="It is smaller than Region [1].", gold=0),
    # --- wide/thin (comparatives: wider/narrower/thinner) ---
    dict(category="wide_thin", answer="Region [0] is wider than Region [1].", response="The crate is wider.", gold=1),
    dict(category="wide_thin", answer="Region [0] is thinner than Region [1].", response="Region [0] is narrower than Region [1].", gold=1),
    dict(category="wide_thin", answer="Region [0] is wider than Region [1].", response="It looks thinner.", gold=0),
    # --- yes/no framings ---
    dict(category="tall_short", answer="Yes.", response="Yes, that's correct.", gold=1),
    dict(category="tall_short", answer="Yes.", response="No, it is not.", gold=0),
    dict(category="big_small", answer="No.", response="no - the opposite.", gold=1),
    # --- quantitative: unit/parse variants (gt_m = parsed meters) ---
    dict(category="distance_data", answer="1.5 meters", response="The distance is 1.5 m.", gt_m=1.5, gold_m=1.5),
    dict(category="distance_data", answer="80 cm", response="about 0.8 meters", gt_m=0.8, gold_m=0.8),
    dict(category="width_data", answer="2 feet", response="around 24 inches", gt_m=0.6096, gold_m=0.6096),
    dict(category="height_data", answer="1.2 m", response="It is roughly 120 centimeters tall.", gt_m=1.2, gold_m=1.2),
    dict(category="distance_data", answer="3.0 meters", response="3", gt_m=3.0, gold_m=3.0),
    dict(category="width_data", answer="0.5 m", response="half a meter", gt_m=0.5, gold_m=0.5),
    dict(category="height_data", answer="2 meters", response="two meters tall", gt_m=2.0, gold_m=2.0),
    dict(category="distance_data", answer="1.75 meters", response="approximately 1.75m away", gt_m=1.75, gold_m=1.75),
    dict(category="vertical_distance_data", answer="30 cm", response="0.3 meters vertically", gt_m=0.3, gold_m=0.3),
    dict(category="horizontal_distance_data", answer="4 ft", response='48"', gt_m=1.2192, gold_m=1.2192),
    # --- direction (clock) ---
    dict(category="direction", answer="3 o'clock", response="at roughly 3 o'clock", clock_gt=3, clock_gold=3),
    dict(category="direction", answer="10 o'clock", response="about 10 oclock from here", clock_gt=10, clock_gold=10),
    dict(category="direction", answer="12 o'clock", response="directly ahead, 12 o clock", clock_gt=12, clock_gold=12),
    # ------------------------------------------------------------------
    # r5 adversarial extension (VERDICT r4 next-#9): phrasings drawn from
    # the round-4 paraphrase banks (synth/prompts.py) — subject-inverted
    # clauses, affirm/negate openers, bank comparatives, number words.
    # --- subject-inverted clauses ("[B] towers over [A]") ---
    dict(category="tall_short", answer="[A] is taller than [B].", response="Right — [A] towers over [B] here.", gold=1),
    dict(category="tall_short", answer="[A] is shorter than [B].", response="Wrong — [A] towers over [B] here.", gold=0),
    dict(category="tall_short", answer="[A] is shorter than [B].", response="[B] towers over [A] here.", gold=1),
    dict(category="tall_short", answer="[B] is taller than [A].", response="[A] is shorter than [B].", gold=1),
    dict(category="big_small", answer="[A] is bigger than [B].", response="Indeed it is — [A] dwarfs [B] overall.", gold=1),
    dict(category="big_small", answer="[A] is bigger than [B].", response="It's the reverse — [B] dwarfs [A] overall.", gold=0),
    dict(category="big_small", answer="[A] is smaller than [B].", response="[B] dwarfs [A] overall.", gold=1),
    dict(category="wide_thin", answer="Region [0] is wider than Region [1].", response="Region [1] is narrower than Region [0].", gold=1),
    dict(category="wide_thin", answer="Region [0] is thinner than Region [1].", response="Region [1] is narrower than Region [0].", gold=0),
    dict(category="below_above", answer="Region [0] is below Region [1].", response="Region [1] is above Region [0].", gold=1),
    dict(category="left_right", answer="Region [0] is to the left of Region [1].", response="Region [1] is to the right of Region [0].", gold=1),
    dict(category="left_right", answer="Region [0] is to the left of Region [1].", response="Region [1] is to the left of Region [0].", gold=0),
    # --- "the former / the latter" ---
    dict(category="big_small", answer="Between [A] and [B], the former is larger.", response="The first region is bigger.", gold=1),
    dict(category="big_small", answer="Between [A] and [B], the latter is larger.", response="The first one is bigger.", gold=0),
    dict(category="wide_thin", answer="Of the two, the latter is wider.", response="The second object is broader.", gold=1),
    # --- negations ---
    dict(category="tall_short", answer="[A] is taller than [B].", response="It is not as tall as [B].", gold=0),
    dict(category="wide_thin", answer="Region [0] is wider than Region [1].", response="Region [0] isn't as wide as Region [1].", gold=0),
    dict(category="big_small", answer="[A] is smaller than [B].", response="[A] is not as large as [B].", gold=1),
    dict(category="below_above", answer="Region [0] is above Region [1].", response="It isn't higher than Region [1].", gold=0),
    # --- affirm/negate bank openers, no side words in the response ---
    dict(category="behind_front", answer="Yes, [A] is behind [B].", response="Confirmed: that is the case.", gold=1),
    dict(category="behind_front", answer="Yes, [A] is behind [B].", response="Quite the opposite, actually.", gold=0),
    dict(category="tall_short", answer="No, it is not.", response="Not quite — the situation is reversed.", gold=1),
    dict(category="tall_short", answer="No, it is not.", response="Exactly so.", gold=0),
    dict(category="big_small", answer="Yes.", response="Certainly — that's how they compare.", gold=1),
    dict(category="big_small", answer="No.", response="It's the reverse.", gold=1),
    dict(category="left_right", answer="Yes, on the left.", response="Affirmative — to the left.", gold=1),
    # --- bank comparatives through new vocabulary ---
    dict(category="wide_thin", answer="Region [0] is thinner than Region [1].", response="It looks slimmer than Region [1].", gold=1),
    dict(category="wide_thin", answer="Region [0] is wider than Region [1].", response="The crate is skinnier than the box beside it.", gold=0),
    dict(category="big_small", answer="Region [0] is smaller.", response="It is the tinier of the two.", gold=1),
    dict(category="below_above", answer="Region [0] is below Region [1].", response="It hangs lower than Region [1].", gold=1),
    dict(category="below_above", answer="Region [0] is above Region [1].", response="It sits higher up than Region [1].", gold=1),
    # --- quantitative: number words / composite phrasings ---
    dict(category="distance_data", answer="1.5 meters", response="one and a half meters", gt_m=1.5, gold_m=1.5),
    dict(category="height_data", answer="2.5 m", response="two and a half meters tall", gt_m=2.5, gold_m=2.5),
    dict(category="width_data", answer="3 feet", response="three feet across", gt_m=0.9144, gold_m=0.9144),
    dict(category="distance_data", answer="40 cm", response="roughly 40 centimeters apart", gt_m=0.4, gold_m=0.4),
    dict(category="distance_data", answer="6 inches", response='about 6"', gt_m=0.1524, gold_m=0.1524),
    dict(category="height_data", answer="1.8 meters", response="just shy of 1.8 m", gt_m=1.8, gold_m=1.8),
    dict(category="width_data", answer="75 cm", response="0.75 meters wide", gt_m=0.75, gold_m=0.75),
    dict(category="vertical_distance_data", answer="half a meter", response="50 cm vertically", gt_m=0.5, gold_m=0.5),
    dict(category="horizontal_distance_data", answer="2 meters", response="a couple of meters: 2 m", gt_m=2.0, gold_m=2.0),
    # --- direction: bank phrasings ---
    dict(category="direction", answer="9 o'clock", response="around the 9 o'clock direction", clock_gt=9, clock_gold=9),
    dict(category="direction", answer="1 o'clock", response="near the 1 o'clock mark", clock_gt=1, clock_gold=1),
    dict(category="direction", answer="6 o'clock", response="toward 6 o'clock", clock_gt=6, clock_gold=6),
]


def calibrate(extractor) -> Dict:
    """Score an extractor against the authored gold set.

    Returns {overall, per_category: {cat: {n, agree}}, failures: [...]}.
    """
    per: Dict[str, Dict] = {}
    failures = []
    n_total = n_agree = 0
    for e in CALIBRATION_SET:
        cat = e["category"]
        rec = per.setdefault(cat, {"n": 0, "agree": 0})
        if "gold" in e:
            mark = extractor.judge_qualitative(
                e.get("question", ""), e["answer"], e["response"], cat
            )
            ok = mark == e["gold"]
        elif "gt_m" in e:
            gt, pred = extractor.extract_distance(
                e.get("question", ""), e["answer"], e["response"]
            )
            ok = (
                gt is not None and pred is not None
                and abs(gt - e["gt_m"]) < 1e-3
                and abs(pred - e["gold_m"]) < 1e-3
            )
        else:
            gt, pred = extractor.extract_direction(
                e.get("question", ""), e["answer"], e["response"]
            )
            ok = gt == e["clock_gt"] and pred == e["clock_gold"]
        rec["n"] += 1
        n_total += 1
        if ok:
            rec["agree"] += 1
            n_agree += 1
        else:
            failures.append(e)
    return {
        "overall": n_agree / max(n_total, 1),
        "per_category": {
            c: {"n": r["n"], "agreement": r["agree"] / r["n"]} for c, r in per.items()
        },
        "failures": failures,
    }


def agreement_with_recorded(
    recorded_jsonl: str, extractor=None
) -> Dict:
    """Agreement of LocalExtractor vs recorded GPT-4 judgments.

    ``recorded_jsonl`` rows: {"category", "question", "answer",
    "response", "mark"} — produced online by running GPT4Extractor over
    bench answers and recording its marks.  Returns the same shape as
    ``calibrate`` (gold = the recorded GPT-4 mark).
    """
    from spatialrgpt_tpu_torch.eval.judge import LocalExtractor

    ex = extractor or LocalExtractor()
    per: Dict[str, Dict] = {}
    n_total = n_agree = 0
    with open(recorded_jsonl) as f:
        for line in f:
            if not line.strip():
                continue
            row = json.loads(line)
            mark = ex.judge_qualitative(
                row.get("question", ""), row["answer"], row["response"],
                row["category"],
            )
            rec = per.setdefault(row["category"], {"n": 0, "agree": 0})
            rec["n"] += 1
            n_total += 1
            if int(mark) == int(row["mark"]):
                rec["agree"] += 1
                n_agree += 1
    return {
        "overall": n_agree / max(n_total, 1),
        "per_category": {
            c: {"n": r["n"], "agreement": r["agree"] / r["n"]} for c, r in per.items()
        },
    }
