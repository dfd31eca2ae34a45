"""The card's idle share inside the engine's admissions in the traced
slice, in percent (``spans.admit_idle_share``)."""

from spans import admit_idle_share as read  # noqa: F401
