"""idle_pct.scan: the card's idle share of the traced window in the beta-scan
cells, in % (``tracing.idle_pct``)."""

from portbench.tracing import idle_pct as read  # noqa: F401
