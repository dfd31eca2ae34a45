"""Per-category few-shot grading examples for the GPT-4 judge.

The reference grades qualitative answers with a per-category few-shot
prompt file (scripts/srgpt/eval/prompt_templates/*.txt, loaded in
evaluate_spatial_with_gpt4.py:176-214: instructions + category examples
formatted with the question + "Your Turn" block, JSON ``{"your_mark"}``
output).  This module provides the same 13-category example bank
(12 predicate categories + choice) with our own wording: each block
teaches the judge that agreement on the predicate's direction scores 1
and disagreement scores 0 — including the double-negation case (answer
and response both reject the predicate).

The port's own copy of ``spatialrgpt_tpu/eval/judge_prompts.py``.
"""

from __future__ import annotations

from typing import Dict

# (category stem) -> (positive phrase, opposite phrase)
_PREDICATE_PHRASES = {
    "left": ("to the left of", "to the right of"),
    "right": ("to the right of", "to the left of"),
    "above": ("above", "below"),
    "below": ("below", "above"),
    "behind": ("behind", "in front of"),
    "front": ("in front of", "behind"),
    "big": ("bigger than", "smaller than"),
    "small": ("smaller than", "bigger than"),
    "tall": ("taller than", "shorter than"),
    "short": ("shorter than", "taller than"),
    "wide": ("wider than", "thinner than"),
    "thin": ("thinner than", "wider than"),
}


def _predicate_block(pos: str, opp: str) -> str:
    return f"""Example 1:
Question: {{question}}
Answer: Yes, Region [0] is {pos} Region [1].
Response: Region [0] is indeed {pos} Region [1].
"your_mark": 1

Example 2:
Question: {{question}}
Answer: Correct - Region [0] sits {pos} Region [1].
Response: Yes, Region [0] is {pos} Region [1].
"your_mark": 1

Example 3:
Question: {{question}}
Answer: Yes, Region [0] is {pos} Region [1].
Response: Actually, Region [0] is {opp} Region [1].
"your_mark": 0

Example 4:
Question: {{question}}
Answer: No, Region [0] is not {pos} Region [1].
Response: Yes, Region [0] is {pos} Region [1].
"your_mark": 0

Example 5:
Question: {{question}}
Answer: No, Region [0] is not {pos} Region [1].
Response: Actually, Region [0] is {opp} Region [1].
"your_mark": 1"""


_CHOICE_BLOCK = """Example 1:
Question: Which one is taller, Region [0] or Region [1]?
Answer: The taller of the two is Region [0].
Response: Region [1] stands taller.
"your_mark": 0

Example 2:
Question: From the viewer's point of view, which is more to the right, Region [0] or Region [1]?
Answer: Region [1] sits further to the right from the viewer's perspective.
Response: Region [1].
"your_mark": 1

Example 3:
Question: Which is closer to the camera, Region [0] or Region [1]?
Answer: The one in front is Region [1].
Response: Region [1] is nearer to the viewer.
"your_mark": 1

Example 4:
Question: Which one is positioned higher, Region [0] or Region [1]?
Answer: Region [1] is the higher one.
Response: Region [0] is further up.
"your_mark": 0"""


def qualitative_examples() -> Dict[str, str]:
    """category key (e.g. 'left_predicate', 'choice') -> few-shot block
    with a ``{question}`` placeholder (predicate blocks only)."""
    bank = {
        f"{stem}_predicate": _predicate_block(pos, opp)
        for stem, (pos, opp) in _PREDICATE_PHRASES.items()
    }
    bank["choice"] = _CHOICE_BLOCK
    return bank


_BANK = qualitative_examples()

_INSTRUCTIONS = """You should help me to evaluate the response given the question and the correct answer.
To mark a response, you should output a single integer between 0 and 1.
1 means that the response perfectly matches the answer.
0 means that the response is completely different from the answer.
The output should be in JSON format.
"""


def build_qualitative_prompt(question: str, answer: str, response: str, category: str) -> str:
    """Assemble the full grading prompt (instructions + category few-shot
    examples + the item under judgment), the reference's
    evaluate_qual_question protocol."""
    key = "choice" if "choice" in category else category
    examples = _BANK.get(key, "")
    if examples:
        examples = examples.format(question=question)
    return (
        _INSTRUCTIONS
        + "\n"
        + examples
        + f"\n\nYour Turn:\nQuestion: {question}\nAnswer: {answer}\nResponse: {response}\n"
    )
