"""SpatialRGPT-Bench scorer.

Rebuild of the reference judge (scripts/srgpt/eval/evaluate_spatial_with_gpt4.py):
same metric surface — per-category qualitative accuracy, quantitative
success (pred in [0.75, 1.25] x gt; direction clock-error <= 1), abs_rel /
rmse / delta<1.25 error stats — writing the same ``score.json`` keys.

Answer/response extraction is pluggable:
  - ``LocalExtractor``: deterministic regex parsing of distances (meters /
    cm / inches / feet conversions) and clock directions, plus a keyword
    matcher for the qualitative pairs.  Fully offline; the default.
  - ``GPT4Extractor``: the reference's GPT-4-turbo protocol (requires
    OPENAI_API_KEY); prompts re-written, same JSON contract.

The port's own copy of ``spatialrgpt_tpu/eval/judge.py``.
"""

from __future__ import annotations

import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

UNIT_TO_METERS = {
    "meter": 1.0,
    "meters": 1.0,
    "m": 1.0,
    "metre": 1.0,
    "metres": 1.0,
    "centimeter": 0.01,
    "centimeters": 0.01,
    "cm": 0.01,
    "millimeter": 0.001,
    "millimeters": 0.001,
    "mm": 0.001,
    "inch": 0.0254,
    "inches": 0.0254,
    "in": 0.0254,
    '"': 0.0254,
    "foot": 0.3048,
    "feet": 0.3048,
    "ft": 0.3048,
}

_NUM_UNIT = re.compile(
    r"(-?\d+(?:\.\d+)?)\s*(meters?|metres?|centimeters?|millimeters?|inches|inch|feet|foot|cm|mm|ft|m|in|\"|'')(?![a-z])",
    re.IGNORECASE,
)
_CLOCK = re.compile(r"(\d{1,2})\s*o'?\s*.?clock", re.IGNORECASE)

# number words -> digits, applied before _NUM_UNIT ("two meters tall")
_NUM_WORDS = {
    "one": "1", "two": "2", "three": "3", "four": "4", "five": "5",
    "six": "6", "seven": "7", "eight": "8", "nine": "9", "ten": "10",
    "eleven": "11", "twelve": "12",
}
_HALF = re.compile(r"\b(?:a\s+)?half\s+(?:a\s+)?(meter|metre|foot|inch)\b", re.IGNORECASE)
# "two and a half meters" (after number-word substitution) -> "2.5 meters"
_N_AND_HALF = re.compile(
    r"(\d+)\s+and\s+(?:a\s+)?half\s+(meters?|metres?|feet|foot|inches|inch)",
    re.IGNORECASE,
)

# qualitative predicate pairs: synonym/comparative sets per side
# (vocabulary covers the r5-extended synth paraphrase banks:
# towers/loftier for tall, dwarfs/eclipses for big, slimmer for thin)
QUAL_PAIRS = [
    (("tall", "taller", "towers", "loftier"), ("short", "shorter", "stubbier"), "tall/short"),
    (("left",), ("right",), "left/right"),
    (("below", "beneath", "under", "underneath", "lower"),
     ("above", "over", "higher"), "below/above"),
    (("behind", "back"), ("front",), "behind/front"),
    (("big", "bigger", "large", "larger", "dwarfs", "eclipses"),
     ("small", "smaller", "tinier"), "big/small"),
    (("wide", "wider", "broad", "broader"),
     ("thin", "thinner", "narrow", "narrower", "slimmer", "skinnier"), "wide/thin"),
]

# "not as tall", "isn't taller", "not wider" — the negated word counts
# for the OPPOSITE side
_NEGATED = re.compile(r"(?:not|n't|isn't|aren't)\s+(?:as\s+|the\s+)?(\w+)")

# subject attribution: a side word whose clause subject is the SECOND
# region ("[B] towers over [A]", "the latter is wider") asserts the
# opposite about the first region — the paraphrase banks use both
# subject orders (synth/prompts.py answer banks)
_REGION_A = re.compile(
    r"\[a\]|\[0\]|region \[?0\]?|the first (?:region|object|one)|the former"
)
_REGION_B = re.compile(
    r"\[b\]|\[1\]|region \[?1\]?|the second (?:region|object|one)|the latter"
)

# polarity leaders (the synth banks' affirm/negate openers) — used when
# side-word comparison is unavailable
_AFFIRM_LEAD = (
    "yes", "correct", "indeed", "affirmative", "that's right", "true",
    "confirmed", "exactly", "quite so", "certainly", "right you are",
    "it is —", "it is -", "sure", "absolutely",
)
_NEGATE_LEAD = (
    "not quite", "not so", "no", "incorrect", "negative", "that's not",
    "it isn't", "false", "quite the opposite", "hardly", "wrong",
    "it's the reverse", "it is not",
)


def _polarity(text: str) -> Optional[int]:
    t = text.strip().lower()
    for w in _NEGATE_LEAD:
        if t.startswith(w):
            return 0
    for w in _AFFIRM_LEAD:
        if t.startswith(w):
            return 1
    return None

QUANT_CATEGORY_NAMES = {
    "vertical_distance_data": "vertical_distance",
    "horizontal_distance_data": "horizontal_distance",
    "distance_data": "direct_distance",
    "width_data": "width",
    "height_data": "height",
    "direction": "direction",
}


def compute_errors(gt: np.ndarray, pred: np.ndarray) -> Dict[str, float]:
    """Depth-style error metrics (reference :61-82), identical formulas."""
    thresh = np.maximum(gt / pred, pred / gt)
    err = np.log(pred) - np.log(gt)
    return dict(
        a1=float((thresh < 1.25).mean()),
        a2=float((thresh < 1.25**2).mean()),
        a3=float((thresh < 1.25**3).mean()),
        abs_rel=float(np.mean(np.abs(gt - pred) / gt)),
        sq_rel=float(np.mean(((gt - pred) ** 2) / gt)),
        rmse=float(np.sqrt(((gt - pred) ** 2).mean())),
        rmse_log=float(np.sqrt(((np.log(gt) - np.log(pred)) ** 2).mean())),
        silog=float(np.sqrt(np.mean(err**2) - np.mean(err) ** 2) * 100),
        log_10=float(np.abs(np.log10(gt) - np.log10(pred)).mean()),
    )


class LocalExtractor:
    """Offline extraction: regex distances + clock directions + keyword
    qualitative matching."""

    def meters(self, text: str) -> Optional[float]:
        text = re.sub(
            r"\b(" + "|".join(_NUM_WORDS) + r")\b",
            lambda m: _NUM_WORDS[m.group(1).lower()],
            text,
            flags=re.IGNORECASE,
        )
        text = _N_AND_HALF.sub(
            lambda m: f"{int(m.group(1)) + 0.5} {m.group(2)}", text
        )
        text = _HALF.sub(lambda m: "0.5 " + m.group(1), text)
        m = _NUM_UNIT.search(text)
        if not m:
            # bare number fallback: treat as meters
            m2 = re.search(r"(-?\d+(?:\.\d+)?)", text)
            return float(m2.group(1)) if m2 else None
        value = float(m.group(1))
        unit = m.group(2).lower()
        if unit in ('"', "''"):
            unit = "in"
        return value * UNIT_TO_METERS.get(unit, 1.0)

    def clock(self, text: str) -> Optional[int]:
        m = _CLOCK.search(text)
        return int(m.group(1)) if m else None

    def extract_distance(self, question, answer, response) -> Tuple[Optional[float], Optional[float]]:
        return self.meters(answer), self.meters(response)

    def extract_direction(self, question, answer, response) -> Tuple[Optional[int], Optional[int]]:
        return self.clock(answer), self.clock(response)

    def judge_qualitative(self, question, answer, response, category) -> int:
        """1 if the response agrees with the answer on the category's
        predicate pair (e.g. both say 'left'), else 0.  Synonyms and
        comparatives count for their side; a negated word ("not as
        tall") counts for the opposite side; a side word whose clause
        subject is the second region asserts the opposite about the
        first; when either text carries no side word, fall through to
        polarity-leader (yes/no-style) agreement."""
        a, r = answer.lower(), response.lower()
        cat = (category or "").lower()
        for ws1, ws2, _ in QUAL_PAIRS:
            hit = any(w in cat for w in ws1 + ws2) or _side(a, ws1, ws2) is not None
            if not hit:
                continue
            a_side = _side(a, ws1, ws2)
            r_side = _side(r, ws1, ws2)
            if a_side is not None and r_side is not None:
                return int(a_side == r_side)
            break
        # polarity-leader fallback (yes/no + the paraphrase banks'
        # affirm/negate openers: "Confirmed:", "It's the reverse —", ...)
        a_pol, r_pol = _polarity(a), _polarity(r)
        if a_pol is not None and r_pol is not None:
            return int(a_pol == r_pol)
        return int(a.strip() == r.strip())


def _side(text: str, ws1, ws2) -> Optional[bool]:
    """Which predicate side does ``text`` assert about the FIRST region?
    True = ws1 side.  Word negation ("not as tall") and second-region
    subjects ("[B] towers over [A]") each flip the side."""
    negated = set(_NEGATED.findall(text))

    def orient(w: str, start: int) -> int:
        sign = -1 if w in negated else 1
        prefix = text[:start]
        la = lb = -1
        for m in _REGION_A.finditer(prefix):
            la = m.end()
        for m in _REGION_B.finditer(prefix):
            lb = m.end()
        if lb > la:  # nearest region mention before the word is B
            sign = -sign
        return sign

    s1 = s2 = 0
    for w in ws1:
        for m in re.finditer(rf"\b{w}\b", text):
            s1 += orient(w, m.start())
    for w in ws2:
        for m in re.finditer(rf"\b{w}\b", text):
            s2 += orient(w, m.start())
    if s1 == s2:
        return None
    return s1 > s2


class GPT4Extractor:
    """GPT-4-turbo extraction, JSON contract as the reference's.  Prompts
    are our own wording with the same examples-in/JSON-out protocol."""

    def __init__(self, model: str = "gpt-4-turbo"):
        import openai

        self.client = openai
        self.model = model

    def _ask(self, content: str) -> Dict:
        resp = self.client.chat.completions.create(
            model=self.model,
            response_format={"type": "json_object"},
            messages=[
                {"role": "system", "content": "You are a helpful assistant designed to output JSON."},
                {"role": "user", "content": content},
            ],
        )
        return json.loads(resp.choices[0].message.content)

    def extract_distance(self, question, answer, response):
        content = (
            "Convert the measurement stated in the answer and in the response to meters "
            "(1 inch = 0.0254 m, 1 foot = 0.3048 m, 1 cm = 0.01 m) and reply as JSON "
            '{"answer_in_meters": <float>, "response_in_meters": <float>}.\n'
            f"Question: {question}\nAnswer: {answer}\nResponse: {response}"
        )
        out = self._ask(content)
        return float(out["answer_in_meters"]), float(out["response_in_meters"])

    def extract_direction(self, question, answer, response):
        content = (
            "Extract the clock direction (1-12) stated in the answer and in the response; "
            'reply as JSON {"answer_direction": <int>, "response_direction": <int>}.\n'
            f"Question: {question}\nAnswer: {answer}\nResponse: {response}"
        )
        out = self._ask(content)
        return int(out["answer_direction"]), int(out["response_direction"])

    def judge_qualitative(self, question, answer, response, category):
        from spatialrgpt_tpu_torch.eval.judge_prompts import build_qualitative_prompt

        content = build_qualitative_prompt(question, answer, response, category)
        return int(self._ask(content)["your_mark"])


def _qual_bucket(category: str) -> str:
    for ws1, ws2, name in QUAL_PAIRS:
        if any(w in category for w in ws1 + ws2):
            return name
    raise ValueError(f"{category} not found")


def score_answers(
    lines: List[Dict],
    extractor=None,
) -> Dict[str, float]:
    """Score a list of answer records ({question, pred, gt, qa_info}) into
    the reference's score.json dict."""
    ex = extractor or LocalExtractor()
    qual = defaultdict(list)
    quant_success = defaultdict(list)
    quant_error = defaultdict(list)
    errors_per_cat = defaultdict(lambda: {"gt": [], "pred": []})
    match_fail = 0

    for data in lines:
        info = data["qa_info"]
        if info["type"] == "quantitative":
            category = info["category"]
            if category not in QUANT_CATEGORY_NAMES:
                continue
            name = QUANT_CATEGORY_NAMES[category]
            if category == "direction":
                try:
                    a, r = ex.extract_direction(data["question"], data["gt"], data["pred"])
                    diff = abs(int(a) - int(r))
                    err = min(diff, 12 - diff)
                    success = err <= 1
                    quant_success[name].append(int(success))
                    quant_error[name].append(err)
                except Exception:
                    match_fail += 1
                    quant_success[name].append(0)
            else:
                try:
                    a, r = ex.extract_distance(data["question"], data["gt"], data["pred"])
                    success = (r <= 1.25 * a) and (r >= 0.75 * a)
                    err = abs(r - a) / (a + 1e-4)
                    quant_success[name].append(int(success))
                    quant_error[name].append(err)
                    if a and r and a > 0 and r > 0:
                        errors_per_cat[category]["gt"].append(a)
                        errors_per_cat[category]["pred"].append(r)
                except Exception:
                    match_fail += 1
                    quant_success[name].append(0)
        elif info["type"] == "qualitative":
            category = info["category"]
            try:
                mark = ex.judge_qualitative(data["question"], data["gt"], data["pred"], category)
            except Exception:
                match_fail += 1
                mark = 0
            qual[_qual_bucket(category)].append(int(mark > 0))

    result: Dict[str, float] = {}
    total_q = correct_q = 0
    for cat, vals in qual.items():
        correct_q += int(np.sum(vals))
        total_q += len(vals)
        result[f"Qual_{cat}_acc"] = float(np.sum(vals) / len(vals) * 100)
    if total_q:
        result["Qual_overall_acc"] = float(correct_q / total_q * 100)

    total_n = correct_n = 0
    for cat, vals in quant_success.items():
        correct_n += int(np.sum(vals))
        total_n += len(vals)
        result[f"Quan_{cat}_acc"] = float(np.sum(vals) / len(vals) * 100)
        if quant_error[cat]:
            result[f"Quan_{cat}_err"] = float(np.sum(quant_error[cat]) / len(quant_error[cat]) * 100)
    if total_n:
        result["Quan_overall_acc"] = float(correct_n / total_n * 100)

    for cat, d in errors_per_cat.items():
        errs = compute_errors(np.asarray(d["gt"]), np.asarray(d["pred"]))
        result[f"Quan_{cat}_absrel"] = round(errs["abs_rel"], 3)
        for k, v in errs.items():
            result[f"Quan_{cat}_{k}"] = round(v, 4)

    result["Match_fail_count"] = match_fail
    return result


def score_file(answers_jsonl: str, extractor=None, out_dir: Optional[str] = None) -> Dict:
    with open(answers_jsonl) as f:
        lines = [json.loads(l) for l in f if l.strip()]
    result = score_answers(lines, extractor)
    out_dir = out_dir or os.path.dirname(answers_jsonl)
    with open(os.path.join(out_dir, "score.json"), "w") as f:
        json.dump(result, f)
    return result
