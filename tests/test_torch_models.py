"""The port's model functions against the JAX package's (the same edge lists,
tolerance: none), and the twins of tests/test_models.py and of the classical
part of tests/test_sampling_freq.py (``chain_edges`` at small n)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pyisingmontecarlo_tpu import models as jmodels
from pyisingmontecarlo_tpu_torch import Lattice, models
from pyisingmontecarlo_tpu_torch.graph import compile_graph, detect_square_torus

torch.set_num_threads(1)


@pytest.mark.parametrize("name,args,kwargs", [
    ("chain_edges", (7,), {}),
    ("chain_edges", (7,), dict(j=0.5, periodic=False)),
    ("chain_edges", (2,), {}),
    ("square_edges", (5,), {}),
    ("square_edges", (4, 6), dict(j=1.0, periodic=False)),
    ("triangular_edges", (6,), {}),
    ("triangular_edges", (5, 7), dict(j=-1.0, periodic=False)),
    ("cubic_edges", (3,), {}),
    ("cubic_edges", (2, 3, 4), dict(periodic=False)),
    ("pm_j_spin_glass_edges", (6,), dict(seed=3)),
    ("pm_j_spin_glass_edges", (5, 4), dict(seed=9, periodic=False)),
    ("gaussian_spin_glass_edges", (4,), dict(seed=1)),
    ("gaussian_spin_glass_edges", (4, 5), dict(seed=2, sigma=0.5)),
])
def test_edge_lists_equal_jax(name, args, kwargs):
    assert getattr(models, name)(*args, **kwargs) == getattr(jmodels, name)(*args, **kwargs)


def test_chain():
    e = models.chain_edges(5)
    assert len(e) == 5 and len(models.chain_edges(5, periodic=False)) == 4
    cg = compile_graph(e)
    assert cg.nvars == 5 and cg.ncolors == 3  # an odd ring needs 3


def test_chain_edges_small_n():
    assert models.chain_edges(2, periodic=True) == [((0, 1), -1.0)]
    assert models.chain_edges(2, periodic=False) == [((0, 1), -1.0)]
    assert len(models.chain_edges(3, periodic=True)) == 3
    with pytest.raises(ValueError):
        models.chain_edges(1)


def test_square_matches_torus_detection():
    assert detect_square_torus(compile_graph(models.square_edges(8, j=-1.0))) == (8, -1.0)


def test_triangular_is_frustrated():
    """E/N of the J = +1 triangular ground state is -1; an annealing of 16
    replicas on the CPU reaches it within 0.3."""
    e = models.triangular_edges(4, j=1.0)
    cg = compile_graph(e)
    assert cg.nedges == 3 * 16 and cg.ncolors >= 3
    cg.validate()
    lat = Lattice(e, seed_gen=0, device="cpu")
    es, _ = lat.run_monte_carlo_annealing([(0, 0.2), (400, 4.0)], 400, 16)
    assert es.min() / 16 == pytest.approx(-1.0, abs=0.3)


def test_cubic():
    cg = compile_graph(models.cubic_edges(3))
    assert cg.nvars == 27 and cg.nedges == 3 * 27
    cg.validate()


def test_spin_glasses_reproducible():
    e1 = models.pm_j_spin_glass_edges(6, seed=3)
    assert e1 == models.pm_j_spin_glass_edges(6, seed=3)
    assert {j for _, j in e1} == {-1.0, 1.0}
    assert np.array([j for _, j in models.gaussian_spin_glass_edges(4, seed=1)]).std() > 0.3
    lat = Lattice(e1, seed_gen=0, device="cpu")
    es, _ = lat.run_monte_carlo_annealing([(0, 0.2), (300, 3.0)], 300, 8)
    assert es.mean() < -40  # 72 bonds
