"""Readers of the serving engine's decode-window spans that say how the
window ran (``spatialrgpt_tpu_torch/serving/engine.py``, opened only while
a profiler runs), in the traced slice:

- ``engine.replay[k]``: inside an ``engine.decode`` span, the launch of the
  window's CUDA graph of k steps;
- ``engine.eager[k]``: inside an ``engine.decode`` span, a window of k
  steps run eagerly.

Each reader reads ``ctx["timeline"]`` alone and returns None where the
slice holds neither span (a program that opens none).
"""

from __future__ import annotations

import re
from typing import Optional

import spans

REPLAY = re.compile(r"engine\.replay\[(\d+)\]")
EAGER = re.compile(r"engine\.eager\[(\d+)\]")


def decode_replay_share(ctx) -> Optional[float]:
    """The share of the slice's ``engine.decode`` spans that hold an
    ``engine.replay[k]`` span, in percent: the decode windows that ran as
    the replay of a graph."""
    tl = ctx.get("timeline")
    if tl is None:
        return None
    decode = spans.spans(tl, spans.DECODE.__eq__)
    replays = spans.spans(tl, REPLAY.fullmatch)
    if not decode or not (replays or spans.spans(tl, EAGER.fullmatch)):
        return None
    held = sum(any(a <= ra and rb <= b for ra, rb, _ in replays) for a, b, _ in decode)
    return 100.0 * held / len(decode)
