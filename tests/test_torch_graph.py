"""The port's graph compilation against the JAX package's: parsing, ELL
adjacency, the three colorings, the engine's color-sorted tensors and the
validation, array for array (tolerance: none), on chain, square, triangular,
cubic, random 4-regular and spin-glass graphs; and the twins of
tests/test_graph.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from pyisingmontecarlo_tpu import graph as jgraph
from pyisingmontecarlo_tpu import models as jmodels
from pyisingmontecarlo_tpu.engines import classical as jce
from pyisingmontecarlo_tpu_torch import graph as tgraph
from pyisingmontecarlo_tpu_torch.engines import classical as tce

torch.set_num_threads(1)


def random_regular_pm_j(n, half_deg, seed):
    """Union of random Hamilton cycles with +-1 couplings (benches/bench_classical_graph.py's glass)."""
    rng = np.random.default_rng(seed)
    seen, edges = set(), []
    for _ in range(half_deg):
        perm = rng.permutation(n)
        for i in range(n):
            a, b = int(perm[i]), int(perm[(i + 1) % n])
            key = (min(a, b), max(a, b))
            if a != b and key not in seen:
                seen.add(key)
                edges.append(((a, b), 1.0 if rng.random() < 0.5 else -1.0))
    return edges


def random_graph(n, E, seed):
    rng = np.random.default_rng(seed)
    pairs = set()
    while len(pairs) < E:
        a, b = rng.integers(0, n, 2)
        if a != b:
            pairs.add((int(min(a, b)), int(max(a, b))))
    return [((a, b), float(rng.normal())) for a, b in sorted(pairs)]


GRAPHS = {
    "chain": jmodels.chain_edges(9),
    "open chain": jmodels.chain_edges(6, periodic=False),
    "square": jmodels.square_edges(6),
    "open square": jmodels.square_edges(5, 4, periodic=False),
    "triangular": jmodels.triangular_edges(6, j=1.0),
    "triangular 5x7": jmodels.triangular_edges(5, 7, j=1.0),
    "cubic": jmodels.cubic_edges(3),
    "4-regular": random_regular_pm_j(40, 2, 7),
    "6-regular": random_regular_pm_j(30, 3, 5),
    "pm-j glass": jmodels.pm_j_spin_glass_edges(6, seed=3),
    "gaussian glass": jmodels.gaussian_spin_glass_edges(5, seed=1),
    "random dense": random_graph(12, 40, 2),
    "isolated vertex": [((0, 2), -1.0), ((2, 3), 1.0)],
    "duplicate edges": [((0, 1), -0.5), ((0, 1), -0.5), ((1, 2), 1.0)],
}


@pytest.fixture(params=sorted(GRAPHS))
def pair(request):
    edges = GRAPHS[request.param]
    return jgraph.compile_graph(edges), tgraph.compile_graph(edges)


def test_compiled_graph_equals_jax(pair):
    j, t = pair
    assert (t.nvars, t.nedges) == (j.nvars, j.nedges)
    for name in ("edge_a", "edge_b", "edge_j", "neighbors", "jmat", "degree", "edge_slot_a", "edge_slot_b",
                 "colors", "edge_colors", "strong_edge_colors"):
        got, want = getattr(t, name), getattr(j, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert (t.max_deg, t.ncolors, t.necolors) == (j.max_deg, j.ncolors, j.necolors)
    for name in ("color_sites", "ecolor_edges", "strong_ecolor_edges"):
        got, want = getattr(t, name), getattr(j, name)
        assert len(got) == len(want), name
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=name)
    t.validate()


def test_python_colorings_equal_jax_python_colorings(pair):
    """The port carries the JAX package's python passes (its native library
    builds the same arrays; the JAX package's tests cross-check the two)."""
    j, t = pair
    args = (j.nvars, j.edge_a, j.edge_b)
    np.testing.assert_array_equal(tgraph._color_sites_python(*args), jgraph._color_sites_python(*args))
    np.testing.assert_array_equal(tgraph._color_edges_python(*args), jgraph._color_edges_python(*args))
    np.testing.assert_array_equal(tgraph._strong_color_edges_python(*args),
                                  jgraph._strong_color_edges_python(*args))
    for g, w in zip(tgraph._build_ell_numpy(*args, j.edge_j), jgraph._build_ell_numpy(*args, j.edge_j)):
        np.testing.assert_array_equal(g, w)


def _same(got, want):
    if want is None:
        assert got is None
        return
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(got.numpy().dtype))


@pytest.mark.parametrize("sort", [False, True])
def test_device_graph_equals_jax(pair, sort):
    """Every tensor of the engine's graph equals the JAX package's array (int64
    indices here, int32 there), the color-sorted numbering, the dense planes
    (bf16 values held in f32) and the int8 matrix included."""
    j, t = pair
    jg = jce.device_graph_sorted(j) if sort else jce.device_graph(j)
    tg = tce.device_graph_sorted(t) if sort else tce.device_graph(t)
    for name in jg._fields:
        want, got = getattr(jg, name), getattr(tg, name)
        if name in ("A_hi", "A_lo", "A_i8"):
            if want is None:
                assert got is None, name
            else:
                np.testing.assert_array_equal(got.numpy(), np.asarray(want, np.float32), err_msg=name)
        elif isinstance(want, tuple):
            assert len(got) == len(want), name
            for g, w in zip(got, want):
                _same(g, w)
        else:
            _same(got, want)


def test_dense_planes_hi_lo_split():
    """Couplings that are not bf16 values keep a lo plane, and hi + lo is
    within 2^-16 of J; integer couplings have only the (int8) hi plane."""
    edges = [((a, b), j * (1 + 2**-10)) for (a, b), j in jmodels.triangular_edges(4, j=1.0)]
    tg = tce.device_graph_sorted(tgraph.compile_graph(edges))
    assert tg.A_lo is not None and tg.A_i8 is None
    A = (tg.A_hi + tg.A_lo).double().numpy()
    want = np.zeros_like(A)
    cg = tgraph.compile_graph(edges)
    ia = tg.iperm.numpy()
    np.add.at(want, (ia[cg.edge_a], ia[cg.edge_b]), cg.edge_j)
    np.add.at(want, (ia[cg.edge_b], ia[cg.edge_a]), cg.edge_j)
    assert np.abs(A - want).max() <= 2**-16 * np.abs(want).max()
    ti = tce.device_graph_sorted(tgraph.compile_graph(jmodels.triangular_edges(4, j=1.0)))
    assert ti.A_lo is None and ti.A_i8 is ti.A_hi
    assert tce.device_graph_sorted(tgraph.compile_graph(GRAPHS["4-regular"]), dense=False).A_hi is None


def test_validate_catches_bad_colorings():
    cg = tgraph.compile_graph(jmodels.triangular_edges(4, j=1.0))
    cg.validate()
    bad = tgraph.compile_graph(jmodels.triangular_edges(4, j=1.0))
    bad._colors = np.zeros(bad.nvars, np.int32)
    with pytest.raises(AssertionError, match="site coloring"):
        bad.validate()
    bad = tgraph.compile_graph(jmodels.triangular_edges(4, j=1.0))
    bad._strong_ecolors = bad.edge_colors.copy()  # proper but not strong
    with pytest.raises(AssertionError, match="strong edge class"):
        bad.validate()


def test_debug_validate_env(monkeypatch):
    monkeypatch.setenv("PMC_DEBUG_VALIDATE", "1")
    cg = tgraph.compile_graph(jmodels.cubic_edges(3))
    assert cg._colors is not None and cg._strong_ecolors is not None


def test_compile_graph_arrays():
    j = jgraph.compile_graph(GRAPHS["triangular"])
    t = tgraph.compile_graph_arrays(j.nvars, j.edge_a, j.edge_b, j.edge_j)
    np.testing.assert_array_equal(t.strong_edge_colors, j.strong_edge_colors)


# ---------------------------------------------------------------- twins of tests/test_graph.py

def test_parse_edges_basic():
    nvars, ea, eb, ej = tgraph.parse_edges([((0, 1), 1.0), ((1, 2), -1.0)])
    assert nvars == 3 and list(ea) == [0, 1] and list(eb) == [1, 2] and list(ej) == [1.0, -1.0]


def test_empty_and_self_loop_raise():
    with pytest.raises(ValueError):
        tgraph.parse_edges([])
    with pytest.raises(ValueError):
        tgraph.parse_edges([((1, 1), 1.0)])


def test_ell_adjacency_roundtrip():
    edges = [((0, 1), 1.0), ((1, 2), -2.0), ((0, 2), 0.5), ((2, 3), 3.0)]
    cg = tgraph.compile_graph(edges)
    seen = {(min(v, int(cg.neighbors[v, d])), max(v, int(cg.neighbors[v, d])), float(cg.jmat[v, d]))
            for v in range(cg.nvars) for d in range(cg.max_deg) if cg.jmat[v, d] != 0.0}
    assert seen == {(min(a, b), max(a, b), j) for (a, b), j in edges}
    assert list(cg.degree) == [2, 2, 3, 1]


def test_site_colorings():
    assert tgraph.compile_graph(tgraph.grid_2d_edges(6, 6)).ncolors == 2  # checkerboard
    assert tgraph.compile_graph([((0, 1), 1.0), ((1, 2), 1.0), ((0, 2), 1.0)]).ncolors == 3
    cg = tgraph.compile_graph(tgraph.grid_2d_edges(4, 4))
    np.testing.assert_array_equal(np.sort(np.concatenate(cg.color_sites)), np.arange(cg.nvars))
