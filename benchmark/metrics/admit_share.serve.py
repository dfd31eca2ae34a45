"""The host's wall inside the engine's admissions over the traced slice's
wall, in percent (``spans.admit_share``)."""

from spans import admit_share as read  # noqa: F401
