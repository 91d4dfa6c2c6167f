"""Throughput counters, device traces and the port's program spans.

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

**Program spans.** While a profiler runs (``trace`` above, or any
``torch.profiler.profile``), the port opens a ``record_function`` range at
each of its layer boundaries listed in ``SPANS``, named ``pmc.<module>.<part>``:

- ``pmc.lattice.run_monte_carlo``: the whole of ``Lattice.run_monte_carlo``,
  on either route; inside it, on the torus route, ``pmc.lattice.setup`` (the
  replicas' seeds, their copy to the card and the random initial states) and
  ``pmc.lattice.states`` (the states compared to +1 and copied to the host,
  after the energies' copy, which waits for the sweeps);
- ``pmc.tempering.qmc_timesteps_sample``: the whole of
  ``LatticeTempering.qmc_timesteps_sample``; inside it (and inside every other
  method that sweeps the ladder) ``pmc.tempering.key_tables`` (the call's seed
  and swap-uniform tables, before the first sweep: the keys' copy to the
  ladder's device, the key chains there, and the advanced keys' copy back) and
  ``pmc.tempering.samples`` (the samples' stack after the accepted swaps were
  read, and their copy to the host);
- ``pmc.lattice.run_quantum_monte_carlo``: the whole of
  ``Lattice.run_quantum_monte_carlo``, on either route; inside it
  ``pmc.worldline.setup`` (``Lattice._worldline``: the replicas' keys, their
  random initial states, the parameters, the lattice's detection, and the
  state's copy to the card and its expansion over the slices) and
  ``pmc.worldline.states`` (slice 0 compared to +1 and copied to the host,
  after the energies' sums were copied, which waits for the sweeps).

No span is opened per sweep. In the exported ``trace.json`` (open it at
https://ui.perfetto.dev or chrome://tracing) the spans lie on the host
thread's track, on the same clock as the kernels and copies on the card's
stream, so a stretch where the card idles can be read off against the span
open above it; ``prof.events()`` holds them by name too. With no profiler
running, ``span`` checks one flag and returns a shared null context: 0.37 us
a span on the host of an NVIDIA H100 80GB HBM3 machine, against 13.6 us for a
bare ``record_function``; under the profiler a span costs about 15.5 us there.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["SweepMeter", "trace", "span", "SPANS"]

SPANS = (
    "pmc.lattice.run_monte_carlo",
    "pmc.lattice.setup",
    "pmc.lattice.states",
    "pmc.tempering.qmc_timesteps_sample",
    "pmc.tempering.key_tables",
    "pmc.tempering.samples",
    "pmc.lattice.run_quantum_monte_carlo",
    "pmc.worldline.setup",
    "pmc.worldline.states",
)

_NULL = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


def span(name: str):
    """The program span ``"pmc." + name`` (one of ``SPANS``) while a profiler
    runs, else a shared null context: ``with span("lattice.setup"): ...``."""
    if _profiling():
        return torch.profiler.record_function("pmc." + name)
    return _NULL


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
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
