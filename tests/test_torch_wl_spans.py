"""The program spans of ``Lattice.run_quantum_monte_carlo``: under
``torch.profiler`` a call records ``pmc.lattice.run_quantum_monte_carlo``
once, with ``pmc.worldline.setup`` and then ``pmc.worldline.states`` inside
it, once each, on the kernel route and on the generic route; with no profiler
running a span is the shared null context; and the results are the same bit
for bit with a profiler running and without one."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile

from pyisingmontecarlo_tpu_torch import Lattice
from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
from pyisingmontecarlo_tpu_torch.utils import profiling
from pyisingmontecarlo_tpu_torch.utils.profiling import SPANS, span

torch.set_num_threads(1)

ENTRY, SETUP, STATES = "pmc.lattice.run_quantum_monte_carlo", "pmc.worldline.setup", "pmc.worldline.states"
# a ring with a chord: no uniform ring or torus, so the generic route
CHORDED = [((i, (i + 1) % 8), -1.0) for i in range(8)] + [((0, 4), 0.5)]


def _lattice(edges, seed=7):
    lat = Lattice(edges, seed_gen=seed, device="cpu")
    lat.set_transverse_field(1.0)
    lat.set_global_bias(0.1)
    return lat


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got: dict = {}
    for e in prof.events():
        if e.name.startswith("pmc."):
            got.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return out, {k: sorted(v) for k, v in got.items()}


@pytest.mark.parametrize("edges", [grid_2d_edges(8, 8, j=-1.0), CHORDED], ids=["kernel_plain", "generic"])
def test_entry_records_setup_then_states_inside_once_each(edges):
    lat = _lattice(edges)
    _, got = _profiled(lambda: lat.run_quantum_monte_carlo(0.4, 3, 2))
    assert set(got) == {ENTRY, SETUP, STATES} <= set(SPANS)
    (entry,), (setup,), (states,) = got[ENTRY], got[SETUP], got[STATES]
    assert entry[0] <= setup[0] and setup[1] <= states[0] and states[1] <= entry[1]


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not profiling._profiling()
    a, b = span("worldline.setup"), span("worldline.states")
    assert a is b and isinstance(a, contextlib.nullcontext)


@pytest.mark.parametrize("edges", [grid_2d_edges(8, 8, j=-1.0), CHORDED], ids=["kernel_plain", "generic"])
def test_results_bit_equal_with_and_without_a_profiler(edges):
    def run():
        lat = _lattice(edges, seed=11)
        return [lat.run_quantum_monte_carlo(0.6, 4, 3), lat.run_quantum_monte_carlo(0.4, 2, 2)]

    plain = run()
    traced, got = _profiled(run)
    assert len(got[ENTRY]) == 2
    for x, y in zip(plain, traced):
        for a, b in zip(x, y):
            np.testing.assert_array_equal(a, b)
