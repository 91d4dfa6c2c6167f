"""The port's native graph library (``_native_graph``, built from
``pyisingmontecarlo_tpu_torch/native/graphc.cpp``) against the port's python
passes and the JAX package's native library: the ELL adjacency and the three
colorings, array for array and dtype for dtype (tolerance: none), on a chain,
a 2-chain, a torus, a triangular and a cubic lattice, a 128^2 +-J glass, a
graph with an isolated vertex and one with duplicate edges. Also which build
``CompiledGraph`` takes (native where ``g++`` is on PATH, python where it is
not), that a source that does not compile raises with the command, and that
processes building at once each load a whole library."""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("jax")

from pyisingmontecarlo_tpu import _native_graph as jng
from pyisingmontecarlo_tpu import models as jmodels
from pyisingmontecarlo_tpu_torch import _native_graph as ng
from pyisingmontecarlo_tpu_torch import graph as tgraph

REPO = Path(__file__).resolve().parent.parent

GRAPHS = {
    "chain": jmodels.chain_edges(9),
    "2-chain": [((0, 1), -1.0)],
    "torus": jmodels.square_edges(8),
    "triangular": jmodels.triangular_edges(6, 5, j=1.0),
    "cubic": jmodels.cubic_edges(4),
    "pm-j glass 128^2": jmodels.pm_j_spin_glass_edges(128, seed=3),
    "isolated vertex": [((0, 2), -1.0), ((2, 3), 1.0)],
    "duplicate edges": [((0, 1), 1.0), ((1, 2), -1.0), ((0, 1), 0.5), ((2, 0), 1.0), ((1, 2), 2.0)],
}
COLORINGS = (("color_sites", "_color_sites_python"), ("color_edges", "_color_edges_python"),
             ("strong_color_edges", "_strong_color_edges_python"))


def _same(got, *wants):
    for want in wants:
        assert type(got) is type(want), (type(got), type(want))
        if isinstance(got, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape, (got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want)
        else:
            assert got == want


def _calls():
    return [getattr(ng, name).calls for name in ("build_ell", "color_sites", "color_edges", "strong_color_edges")]


@pytest.fixture(scope="module")
def jax_native():
    """The JAX package's native library. Its loader tries once a process and
    keeps a failure, and a worker may have tried while another worker's g++
    was still writing the library: then it loads again."""
    if not jng.available():
        jng._tried = False
    assert jng.available()
    return jng


@pytest.mark.parametrize("name", list(GRAPHS))
def test_native_equals_python_and_jax_native(name, jax_native):
    assert ng.available()
    nvars, ea, eb, ej = tgraph.parse_edges(GRAPHS[name])
    for got, py, jax_arr in zip(ng.build_ell(nvars, ea, eb, ej), tgraph._build_ell_numpy(nvars, ea, eb, ej),
                                jax_native.build_ell(nvars, ea, eb, ej)):
        _same(got, py, jax_arr)
    for native, python in COLORINGS:
        _same(getattr(ng, native)(nvars, ea, eb), getattr(tgraph, python)(nvars, ea, eb),
              getattr(jax_native, native)(nvars, ea, eb))


def test_compiled_graph_takes_native_build():
    cg = tgraph.compile_graph(GRAPHS["triangular"])
    before = _calls()
    arrays = (cg.neighbors, cg.jmat, cg.degree, cg.edge_slot_a, cg.colors, cg.edge_colors, cg.strong_edge_colors)
    assert _calls() == [c + 1 for c in before]
    ell = tgraph._build_ell_numpy(cg.nvars, cg.edge_a, cg.edge_b, cg.edge_j)
    for got, want in zip(arrays, (ell[0], ell[1], ell[2], ell[4])):
        _same(got, want)
    for got, (_, python) in zip(arrays[4:], COLORINGS):
        _same(got, getattr(tgraph, python)(cg.nvars, cg.edge_a, cg.edge_b))
    cg.validate()


def test_no_compiler_takes_python_passes(monkeypatch):
    monkeypatch.setattr(shutil, "which", lambda *a, **k: None)
    assert not ng.available()
    with pytest.raises(RuntimeError, match="not found"):
        ng.build()
    cg = tgraph.compile_graph(GRAPHS["cubic"])
    before = _calls()
    ell = cg._ensure_ell()
    got = (cg.colors, cg.edge_colors, cg.strong_edge_colors)
    assert _calls() == before
    monkeypatch.undo()
    for g, want in zip(ell, ng.build_ell(cg.nvars, cg.edge_a, cg.edge_b, cg.edge_j)):
        _same(g, want)
    for g, (native, _) in zip(got, COLORINGS):
        _same(g, getattr(ng, native)(cg.nvars, cg.edge_a, cg.edge_b))


def test_broken_source_raises_with_the_command(tmp_path):
    src = tmp_path / "graphc.cpp"
    src.write_text(ng.SOURCE.read_text().replace("int32_t graphc_degrees(", "int32_t graphc_degrees(;", 1))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        ng.build(src, tmp_path / "build")
    assert str(src) in str(err.value) and "-march=native" in str(err.value)
    assert not list((tmp_path / "build").glob("*"))


def test_build_named_by_source_hash(tmp_path):
    lib = ng.build(ng.SOURCE, tmp_path)
    assert ng.build(ng.SOURCE, tmp_path) == lib and lib.name.startswith("libgraphc-")
    src = tmp_path / "graphc.cpp"
    src.write_text(ng.SOURCE.read_text() + "\n// another source\n")
    other = ng.build(src, tmp_path)
    assert other != lib and sorted(p.name for p in tmp_path.glob("*.so")) == sorted([lib.name, other.name])
    assert not list(tmp_path.glob("*.tmp"))


def test_concurrent_builds_each_load(tmp_path):
    """Six processes build into one empty directory at once; each loads a
    whole library (its symbols resolve); one library is left, and no
    temporary file."""
    code = (
        "import ctypes, sys\n"
        "from pyisingmontecarlo_tpu_torch import _native_graph as ng\n"
        "lib = ctypes.CDLL(str(ng.build(ng.SOURCE, sys.argv[1])))\n"
        "assert lib.graphc_color_sites\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(6)]
    for p in procs:
        out, _ = p.communicate(timeout=120)
        assert p.returncode == 0, out
    assert len(list(tmp_path.glob("*.so"))) == 1 and not list(tmp_path.glob("*.tmp"))
