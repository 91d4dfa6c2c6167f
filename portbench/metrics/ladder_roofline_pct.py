"""ladder_roofline_pct: the ladder kernels' share of their roofline, in %.

The least time of the traced sweeps (``reference/counts.py``:
``ladder_need`` at the card's peaks, with the cluster heads a sweep that the
state at the end of the trace implies) over the time of ``ladder_site`` and
``ladder_cluster`` in the trace (each one's recorded launches' mean times
its launches: ``ladder_sweeps.launches`` counted, half of them each). None
without a recorded launch of both."""

from portbench.reference import counts

KERNELS = ("ladder_site", "ladder_cluster")


def read(view):
    launches = view.counters.get("ladder_sweeps.launches")
    times = [view.kernel_us(k, launches / 2 if launches else None) for k in KERNELS]
    if None in times or not view.work.get("sweeps"):
        return None
    i = view.info
    need = counts.ladder_need(i["R"], i["nvars"], i["L"], view.work["sweeps"], i["heads_per_sweep"])
    return 100.0 * counts.least_s(*need) / (sum(times) * 1e-6)
