"""The port's drop-in module ``py_monte_carlo_torch`` (the twin of
tests/test_compat_shim.py): its five names, the reference README's first
example with ``device="cpu"``, the default device, and the port's
``SweepMeter``; and the method surface of the port's ``LatticeTempering``
against tests/test_api_surface.py's ``TEMPERING``."""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import pyisingmontecarlo_tpu_torch as tpmc
import test_api_surface

NAMES = ("Lattice", "ClassicIsing", "QmcIsing", "QmcRunner", "LatticeTempering")


def test_py_monte_carlo_torch_module_names():
    import py_monte_carlo_torch

    assert sorted(py_monte_carlo_torch.__all__) == sorted(NAMES)
    for name in NAMES:
        assert getattr(py_monte_carlo_torch, name) is getattr(tpmc, name), name


def test_readme_usage_example():
    # the reference README's first example, on the port's CPU path
    import py_monte_carlo_torch as py_monte_carlo

    edges = [((0, 1), 1.0), ((1, 2), -1.0)]
    lat = py_monte_carlo.Lattice(edges, device="cpu")
    es, ss = lat.run_monte_carlo(1.0, 10, 4)
    assert es.shape == (4,) and ss.shape == (4, 3)
    assert es.dtype == "float64" and ss.dtype == bool


def test_default_device_is_the_card():
    import py_monte_carlo_torch

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA; the check is for hosts without it")
    with pytest.raises(RuntimeError, match="cuda"):
        py_monte_carlo_torch.Lattice([((0, 1), 1.0), ((1, 2), -1.0)])


def test_profiling_meter():
    from pyisingmontecarlo_tpu_torch.utils.profiling import SweepMeter

    with SweepMeter() as m:
        m.add(sweeps=10, sites=1000)
    assert m.sweeps_per_s > 0 and m.updates_per_ns > 0
    assert "sweeps" in m.report()


def test_tempering_method_surface():
    """tests/test_api_surface.py's rule, on the port's class: the reference's
    parameters in order, required ones without a default, optional ones with
    one; keyword-only extensions (``dtau``, ``device``) must default."""
    test_api_surface.test_method_surface(tpmc.LatticeTempering, test_api_surface.TEMPERING)
