"""Requests per admission prefill in the traced slice (``spans.admit_width``)."""

from spans import admit_width as read  # noqa: F401
