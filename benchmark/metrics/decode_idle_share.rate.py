"""The card's idle share inside the engine's decode windows in the traced
slice, in percent (``spans.decode_idle_share``)."""

from spans import decode_idle_share as read  # noqa: F401
