"""The port's program spans (``utils/profiling.span``): under
``torch.profiler`` each entry point records its ``pmc.`` ranges once a call,
nested by time inside the entry's own span, every name in ``SPANS``; with no
profiler running a span is the shared null context; and the results are the
same bit for bit with a profiler running and without one."""

import contextlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile

from pyisingmontecarlo_tpu_torch import Lattice, LatticeTempering
from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
from pyisingmontecarlo_tpu_torch.utils import profiling
from pyisingmontecarlo_tpu_torch.utils.profiling import SPANS, span

torch.set_num_threads(1)

RING8 = [((i, (i + 1) % 8), -1.0) for i in range(8)]
# a ring with a chord: off the ladder kernel's gate, so the generic route
CHORDED = RING8 + [((0, 4), 0.5)]
TRI = [((0, 1), 1.0), ((1, 2), 1.0), ((0, 2), -1.0)]  # no torus: the graph engine's route


def _torus():
    lat = Lattice(grid_2d_edges(8, 8, j=-1.0), seed_gen=5, device="cpu")
    lat.set_global_bias(0.1)
    return lat


def _ladder(edges):
    lt = LatticeTempering(edges, seed=3, device="cpu")
    for b in (0.5, 0.7, 0.9):
        lt.add_graph(1.0, 0.1, b)
    return lt


def _spans(prof) -> dict:
    """``{name: [(start, end)]}`` of the recorded ``pmc.`` ranges, in time order."""
    out: dict = {}
    for e in prof.events():
        if e.name.startswith("pmc."):
            out.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    return {k: sorted(v) for k, v in out.items()}


def _inside(inner, outer) -> bool:
    """Every interval of ``inner`` lies inside one of ``outer``."""
    return all(any(a <= s and e <= b for a, b in outer) for s, e in inner)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_torus_entry_records_setup_and_states_inside():
    lat = _torus()
    assert lat._fast2d()
    _, got = _profiled(lambda: [lat.run_monte_carlo(0.4, 3, 2), lat.run_monte_carlo(0.5, 2, 3)])
    entry = got["pmc.lattice.run_monte_carlo"]
    assert len(entry) == 2
    assert len(got["pmc.lattice.setup"]) == 2 and len(got["pmc.lattice.states"]) == 2
    assert _inside(got["pmc.lattice.setup"], entry) and _inside(got["pmc.lattice.states"], entry)
    # the states' span starts after the set-up's has ended, in each call
    assert all(su[1] <= st[0] for su, st in zip(got["pmc.lattice.setup"], got["pmc.lattice.states"]))


def test_graph_route_records_the_entry_alone():
    lat = Lattice(TRI, seed_gen=1, device="cpu")
    assert not lat._fast2d()
    _, got = _profiled(lambda: lat.run_monte_carlo(0.5, 3, 2))
    assert set(got) == {"pmc.lattice.run_monte_carlo"} and len(got["pmc.lattice.run_monte_carlo"]) == 1


@pytest.mark.parametrize("edges,route", [(RING8, "planes"), (CHORDED, "ga")], ids=["kernel_plain", "generic"])
def test_tempering_records_key_tables_and_samples_inside(edges, route):
    lt = _ladder(edges)
    assert route in lt._materialize()
    _, got = _profiled(lambda: [lt.qmc_timesteps_sample(3), lt.qmc_timesteps_sample(2, sampling_freq=2)])
    entry = got["pmc.tempering.qmc_timesteps_sample"]
    assert len(entry) == 2 and len(got["pmc.tempering.key_tables"]) == 2
    assert len(got["pmc.tempering.samples"]) == 4  # the stack in the sweep loop, the copy in the entry
    for name in ("pmc.tempering.key_tables", "pmc.tempering.samples"):
        assert _inside(got[name], entry), name
    # each call's key tables come before its samples
    for (a, b), tables in zip(entry, got["pmc.tempering.key_tables"]):
        assert a <= tables[0] and all(tables[1] <= s for s, e in got["pmc.tempering.samples"] if a <= s <= b)


def test_span_is_the_shared_null_context_without_a_profiler():
    assert not profiling._profiling()
    a, b = span("lattice.setup"), span("tempering.samples")
    assert a is b and isinstance(a, contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(span("lattice.setup"), torch.profiler.record_function)
    assert span("lattice.setup") is a


def _torus_run():
    return _torus().run_monte_carlo(0.45, 4, 3)


def _graph_run():
    return Lattice(TRI, seed_gen=2, device="cpu").run_monte_carlo(0.5, 4, 3)


def _quantum_run():
    lat = Lattice(grid_2d_edges(8, 8, j=-1.0), seed_gen=4, device="cpu")
    lat.set_transverse_field(1.0)
    return lat.run_quantum_monte_carlo(0.4, 3, 2)


def _ladder_run(edges):
    def run():
        lt = _ladder(edges)
        states, energies = lt.qmc_timesteps_sample(4)
        return states, energies, lt.get_total_swaps(), np.stack([lt.get_graph_itime(g) for g in range(3)])
    return run


@pytest.mark.parametrize("run", [_torus_run, _graph_run, _ladder_run(RING8), _ladder_run(CHORDED), _quantum_run],
                         ids=["torus", "graph", "ladder_kernel_plain", "ladder_generic", "quantum"])
def test_results_bit_equal_with_and_without_a_profiler(run):
    plain = run()
    traced, got = _profiled(run)
    assert got  # the profiled run recorded its spans
    assert len(plain) == len(traced)
    for x, y in zip(plain, traced):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_recorded_names_are_listed_and_name_no_kernel():
    runs = (_torus_run, _graph_run, _ladder_run(RING8), _ladder_run(CHORDED), _quantum_run)
    _, got = _profiled(lambda: [run() for run in runs])
    assert set(got) == set(SPANS)
    assert len(set(SPANS)) == len(SPANS) and all(n.startswith("pmc.") for n in SPANS)
    for witness in ("sq2d_tiled", "ladder_", "wl_", "fk_long"):
        assert not any(witness in n for n in SPANS)
