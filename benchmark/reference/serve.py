"""The served-token check in plain PyTorch: the composite runs once over
each sampled request's prompt and the tokens the program served, and each
served token's logit is read against the best logit at its position."""

from __future__ import annotations

from typing import Dict, List

import torch

from reference.model import Composite, pad_rows


def served_logits(model: Composite, requests: List[dict]) -> List[torch.Tensor]:
    """Per request (T, V) float32 logits at the positions that predict its T
    served tokens: the last prompt position and each served token but the
    last.  A request is a dict of ``ids`` (the prompt with the image
    placeholder), ``tokens`` (served), ``image``, ``depth`` (S, S, 3) and
    ``masks`` (R, S, S)."""
    stack = lambda key: torch.stack([r[key] for r in requests])  # noqa: E731
    img, mask_emb, depth_emb = model.encode(stack("image"), stack("depth"), stack("masks"))
    table = model.W["llm.model.embed_tokens.weight"]
    rows, spans = [], []
    for i, r in enumerate(requests):
        prompt = model.splice(r["ids"], img[i], mask_emb[i], depth_emb[i])
        fed = torch.as_tensor(r["tokens"][:-1], dtype=torch.int64, device=prompt.device)
        rows.append(torch.cat([prompt, table[fed].float()]))
        spans.append((prompt.shape[0] - 1, len(r["tokens"])))
    x, pos, seg = pad_rows(rows)
    h = model.decode_stack(x, pos, seg)
    return [model.logits(h[b, start : start + n]) for b, (start, n) in enumerate(spans)]


def _gap(lg: torch.Tensor, tokens: torch.Tensor) -> list:
    return (lg.max(dim=-1).values - lg.gather(-1, tokens[:, None])[:, 0]).tolist()


@torch.no_grad()
def gaps(c: dict, W: Dict[str, torch.Tensor], requests: List[dict], control: str = None) -> Dict[str, list]:
    """``served``: per request, each served token's gap below the
    reference's best logit at its position (0 where the reference puts it
    first).  With ``control`` (a lower precision of ``model.py``) also
    ``control``: the gap of the token that the lower precision puts first,
    at the same positions."""
    ref = served_logits(Composite(c, W), requests)
    out = {"served": [_gap(lg, torch.as_tensor(r["tokens"], device=lg.device)) for r, lg in zip(requests, ref)]}
    if control:
        low = served_logits(Composite(c, W, lowp=control), requests)
        out["control"] = [_gap(lg, lo.argmax(dim=-1)) for lg, lo in zip(ref, low)]
    return out
