"""idle_pct.updates: the card's idle share of the traced window in the
cells that report spin updates, in % (``tracing.idle_pct``)."""

from portbench.tracing import idle_pct as read  # noqa: F401
