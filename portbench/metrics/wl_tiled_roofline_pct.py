"""wl_tiled_roofline_pct: the tiled worldline kernel's share of its
roofline, in %.

The least time of the traced sweeps (``reference/wl_counts.py``: ``wl_need``
at the card's peaks of ``reference/counts.py``, with the fewest cluster heads
a sweep, ``info()``'s ``heads_per_sweep``) over ``wl_tiled``'s time in the
trace (its recorded launches' mean times the launches
``wl_sweeps.tiled_launches`` counted). None without a recorded launch."""

from portbench.reference import counts, wl_counts


def read(view):
    t_us = view.kernel_us("wl_tiled", view.counters.get("wl_sweeps.tiled_launches"))
    if not t_us or not view.work.get("sweeps"):
        return None
    i = view.info
    need = wl_counts.wl_need(i["R"], i["nvars"], i["L"], view.work["sweeps"], i["heads_per_sweep"])
    return 100.0 * counts.least_s(*need) / (t_us * 1e-6)
