"""sq2d_roofline_pct: the torus sweep kernel's share of its roofline, in %.

The least time of the traced calls' site updates (``reference/counts.py``:
``sq2d_need`` at the card's peaks) over ``sq2d_tiled``'s time in the trace
(its recorded launches' mean times the launches ``sweeps_2d.launches``
counted). None without a recorded launch."""

from portbench.reference import counts


def read(view):
    t_us = view.kernel_us("sq2d_tiled", view.counters.get("sweeps_2d.launches"))
    if not t_us or not view.calls:
        return None
    i = view.info
    return 100.0 * counts.least_s(*counts.sq2d_need(i["R"], i["L"], i["T"], view.calls)) / (t_us * 1e-6)
