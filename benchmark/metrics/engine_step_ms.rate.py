"""Host milliseconds per decode step of the engine's public ``step`` calls
before the traced slice (``readers.engine_step_ms``)."""

from readers import engine_step_ms as read  # noqa: F401
