"""LLM rephrasing of template QA.

Rebuild of the reference's run_llm.py path (dataset_pipeline/run_llm.py:
an LLM rewrites the template-generated QA into natural language).  The
rephraser is a callable (prompt -> text) so it can be backed by the local
serving engine, an API, or a fake in tests; falls back to identity.

The port's own copy of ``spatialrgpt_tpu/synth/rephrase.py``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

REPHRASE_PROMPT = (
    "Rewrite the following question and answer about objects in an image "
    "so they sound natural and conversational, keeping every factual "
    "detail (distances, directions, object references) unchanged.\n"
    "Question: {q}\nAnswer: {a}\n"
    "Reply exactly as two lines:\nQ: <question>\nA: <answer>"
)


def rephrase_qa(
    qa_pairs: List[Dict],
    llm: Optional[Callable[[str], str]] = None,
) -> List[Dict]:
    """qa_pairs: [{'question', 'answer', ...}] -> same with rephrased text
    (original kept under 'template_question'/'template_answer')."""
    out = []
    for qa in qa_pairs:
        item = dict(qa)
        item["template_question"] = qa["question"]
        item["template_answer"] = qa["answer"]
        if llm is not None:
            try:
                resp = llm(REPHRASE_PROMPT.format(q=qa["question"], a=qa["answer"]))
                q, a = _parse(resp)
                if q and a:
                    item["question"], item["answer"] = q, a
            except Exception:
                pass  # keep template text on any failure
        out.append(item)
    return out


def _parse(resp: str):
    q = a = None
    for line in resp.splitlines():
        line = line.strip()
        if line.startswith("Q:"):
            q = line[2:].strip()
        elif line.startswith("A:"):
            a = line[2:].strip()
    return q, a
