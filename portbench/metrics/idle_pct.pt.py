"""idle_pct.pt: the card's idle share of the traced window in the tempering
cells, in % (``tracing.idle_pct``)."""

from portbench.tracing import idle_pct as read  # noqa: F401
