"""The traced window: torch.profiler over a few back-to-back calls, and the
reductions that per-layer metrics read.

The profiler drops device records on the H100 machine, even after a
warm-up step, and never adds any. So a traced window is taken again, up to
``TRIES`` times, until the launches it records of the driver's witness
kernels equal what the program's own counters say it launched; the trace
that recorded the most is kept. A kernel's time is then its recorded
launches' mean times the counted launches, which a dropped record does not
change.
"""

from __future__ import annotations

import sys

__all__ = ["TRIES", "CALL", "TraceView", "trace_window", "union_us", "idle_pct"]

TRIES = 3
CALL = "portbench.call"  # the host range around each traced call


def union_us(intervals, lo=None, hi=None) -> float:
    """The length of the union of ``(start, end)`` intervals, clipped to ``[lo, hi]``."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if lo is not None:
            s = max(s, lo)
        if hi is not None:
            e = min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


class TraceView:
    """What a traced window recorded, in microseconds on the profiler's clock:
    ``device`` ``[(name, start, end)]`` of every kernel, copy and set on the
    card, ``host`` the same of the host's operations, ``window`` the span of
    the traced calls; ``calls``, ``work`` and ``counters`` (the program's
    counters' change) over those calls, ``info`` the driver's shapes; and
    ``attempted`` and ``failed`` calls of all attempts."""

    def __init__(self, device, host, window, calls, work, counters, info, attempted=0, failed=0, recorded=None):
        self.device, self.host, self.window = device, host, window
        self.calls, self.work, self.counters, self.info = calls, work, counters, info
        self.attempted, self.failed, self.recorded = attempted, failed, recorded

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_us([(s, e) for _, s, e in self.device], *self.window) * 1e-6

    def durations(self, part: str) -> list:
        """Recorded durations (us) of the device operations whose names hold ``part``."""
        return [e - s for n, s, e in self.device if part in n]

    def kernel_us(self, part: str, launches) -> float | None:
        """A kernel's time: its recorded launches' mean times ``launches``, or None unrecorded."""
        d = self.durations(part)
        if not d or not launches:
            return None
        return sum(d) / len(d) * launches

    def other(self, parts) -> list:
        """The device operations whose names hold none of ``parts``."""
        return [(n, s, e) for n, s, e in self.device if not any(p in n for p in parts)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps labelled by the innermost host operation open at their middle."""
        per: dict = {}
        for n, s, e in self.device:
            per[n] = per.get(n, 0.0) + (e - s)
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        busy = sorted((s, e) for _, s, e in self.device)
        gaps, t = [], self.window[0]
        for s, e in busy + [(self.window[1], self.window[1])]:
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:top]:
            mid = (a + b) / 2
            inner = [(e - s, n) for n, s, e in self.host if s <= mid <= e and not n.startswith("ProfilerStep")]
            label = min(inner)[1] if inner else "no host operation recorded"
            out.append([label if label != CALL else "host code of the call, outside any torch operation",
                        (b - a) * 1e-6])
        return {"device_ops": [[n[:160], us * 1e-6] for n, us in ops], "idle_gaps": out}


def idle_pct(view: TraceView):
    """The share of the traced window in which no kernel, copy or set ran on
    the card, in %; None without device records."""
    if not view.device or view.window_s <= 0:
        return None
    return 100.0 * (1.0 - view.busy_s / view.window_s)


def _events(prof):
    import torch

    dev, host = [], []
    for e in prof.events():
        if not e.name:
            continue
        row = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type != torch.autograd.DeviceType.CUDA:
            host.append(row)
        elif not (getattr(e, "is_user_annotation", False) or e.name == CALL or e.name.startswith("ProfilerStep")):
            dev.append(row)  # a host range's shadow on the device timeline is no device operation
    return dev, host


def trace_window(driver, n_calls: int, tries: int = TRIES) -> TraceView:
    """Trace ``n_calls`` back-to-back calls after one call under the
    profiler's warm-up step, up to ``tries`` times (module docstring)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def sync():
        if cuda:
            torch.cuda.synchronize()

    best, attempted, failed = None, 0, 0
    for _ in range(tries):
        with profile(activities=acts, schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            try:
                driver.call()
                attempted += 1
                sync()
                prof.step()
                c0 = driver.counters()
                work: dict = {}
                for _ in range(n_calls):
                    with record_function(CALL):
                        done = driver.call()
                    attempted += 1
                    for k, v in done.items():
                        work[k] = work.get(k, 0) + v
                sync()
                c1 = driver.counters()
                prof.step()
            except Exception as e:  # the program's failure is the run's result: counted and reported
                print(f"traced call failed: {type(e).__name__}: {e}", file=sys.stderr)
                attempted += 1
                failed += 1
        if failed:
            break
        device, host = _events(prof)
        calls = [(s, e) for n, s, e in host if n == CALL]
        if not calls:
            continue
        window = (min(s for s, _ in calls), max(max(e for _, e in calls), max((e for _, _, e in device), default=0)))
        counters = {k: c1[k] - c0[k] for k in c1}
        want = sum(counters[k] for _, k in driver.WITNESS)
        got = sum(1 for n, _, _ in device if any(p in n for p, _ in driver.WITNESS))
        view = TraceView(device, host, window, n_calls, work, counters, None, recorded=(got, want))
        if best is None or got > best.recorded[0]:
            best = view
        if got >= want:
            break
    if best is None:
        return TraceView([], [], (0.0, 0.0), 0, {}, {}, driver.info(), attempted, failed, (0, 0))
    best.attempted, best.failed, best.info = attempted, failed, driver.info()
    print(f"trace: {best.recorded[0]} witness launches recorded, the program counts {best.recorded[1]}",
          file=sys.stderr)
    return best
