"""The share of the traced slice's decode windows that ran as the replay
of a CUDA graph, in percent (``graphs.decode_replay_share``)."""

from graphs import decode_replay_share as read  # noqa: F401
