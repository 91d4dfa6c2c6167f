"""Throughput counters and device traces.

Counterpart of ``pyisingmontecarlo_tpu/utils/profiling.py``: ``SweepMeter``
as there, and ``trace`` on ``torch.profiler`` in place of ``jax.profiler``::

    from pyisingmontecarlo_tpu_torch.utils.profiling import SweepMeter, trace

    with trace("out/trace"):           # writes out/trace/trace.json (chrome://tracing, Perfetto)
        with SweepMeter() as m:
            lat.run_monte_carlo(0.4, 1000, 64)
            m.add(sweeps=1000, sites=64 * 1024**2)
    print(m.report())                  # sweeps/s and site-updates/ns

The meter reads the host clock: the results of the timed calls must be on the
host (the ``run_*`` methods return numpy arrays) before the block ends.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

__all__ = ["SweepMeter", "trace"]


@dataclass
class SweepMeter:
    """Wall-clock throughput counter for Monte Carlo runs."""

    sweeps: float = 0.0
    site_updates: float = 0.0
    _t0: float = field(default=0.0, repr=False)
    elapsed: float = 0.0

    def __enter__(self) -> "SweepMeter":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed += time.perf_counter() - self._t0

    def add(self, sweeps: float = 0.0, sites: float = 0.0) -> None:
        """Record ``sweeps`` sweeps over ``sites`` total site-updates."""
        self.sweeps += sweeps
        self.site_updates += sites

    @property
    def sweeps_per_s(self) -> float:
        return self.sweeps / self.elapsed if self.elapsed else 0.0

    @property
    def updates_per_ns(self) -> float:
        return self.site_updates / (self.elapsed * 1e9) if self.elapsed else 0.0

    def report(self) -> str:
        return (
            f"{self.sweeps:.0f} sweeps in {self.elapsed:.3f}s "
            f"({self.sweeps_per_s:.1f} sweeps/s, "
            f"{self.updates_per_ns:.2f} site-updates/ns)"
        )


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block (CPU, and CUDA where there is a card),
    written to ``log_dir/trace.json`` as a Chrome trace; yields the profiler,
    whose ``key_averages()`` sum the time by operation and kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
