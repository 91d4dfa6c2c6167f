"""The port's program spans in a traced window: ``record_function`` ranges
named ``pmc.<module>.<part>`` that the port opens while a profiler runs, read
from ``TraceView.host`` on the same clock as the device's records. A program
without them (an older checkout) records none, and every reader here gives
None there."""

from __future__ import annotations

from portbench.tracing import union_us

__all__ = ["intervals", "ms_per_call", "idle_us"]


def intervals(view, name: str) -> list:
    """The ``(start, end)`` of every span ``name`` that reaches into the
    window, clipped to it."""
    lo, hi = view.window
    return [(max(s, lo), min(e, hi)) for n, s, e in view.host if n == name and s < hi and e > lo]


def ms_per_call(view, name: str):
    """The host time inside span ``name`` within the window, in ms over the
    traced calls; None without such a span."""
    spans = intervals(view, name)
    return union_us(spans) * 1e-3 / view.calls if spans and view.calls else None


def idle_us(view, name: str):
    """The time inside span ``name`` within the window in which no device
    operation ran, in us; None without such a span."""
    spans = intervals(view, name)
    if not spans:
        return None
    busy = [(s, e) for _, s, e in view.device]
    return sum((e - s) - union_us(busy, s, e) for s, e in spans)
