"""The card's idle share in the traced slice, in percent (``readers.idle_share``)."""

from readers import idle_share as read  # noqa: F401
