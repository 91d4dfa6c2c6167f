"""The worldline kernel's plain version at time lines past 4096 slices, up
to the JAX kernel's gate (a replica's int32 plane of nvars * L_tau within 16
MiB, so L_tau up to 2^20 on the 4-ring), where the multi-launch route runs
on the card (``csrc/wl.cu``; the cluster phase in one block up to 26,944
slices on an H100, then ``fk_long_*`` in global memory).

- ``run_wl_sweeps`` against the JAX Pallas kernel in interpret mode, R = 2,
  2 sweeps: the 8-ring at L_tau = 5120, the 16-ring at 40,960 (a plane past
  2 MiB: the JAX kernel's row accumulators and dispatch chunks), and the
  4-ring at 262,144 at dtau * Gamma = 2.7e-6, where about half the lines
  are frozen whole (summed in XLA's order, three levels of windows) and the
  others hold runs of tens of thousands of slices.
- ``xla_sum_last`` against XLA's ``jnp.sum`` at the three-level windows' edge
  (32,768 +- 32), at 40,960 and at 2^20.
- ``wl.gate`` against the JAX kernel's rule (``wl_pallas.supported``, whose
  platform test refuses the CPU, so the rule is read from
  ``_MAX_PLANE_BYTES_LARGE``) on a grid of shapes on both sides of each edge,
  at replica counts past 2^31 spins and past 65,535 replicas, which the JAX
  rule does not read; a worldline ensemble (``Lattice``'s and
  ``QmcIsing``'s) on the 4-ring at L_tau = 2^20 stays on the kernel route at
  R = 512, also after ``append`` grows it there (on the meta device: shapes
  only, no plane built).

The kernels themselves run only on the card, where ``chip_smoke.py``
compare-longline holds them to the plain version bit for bit at these
lengths. Tolerance: none; every comparison is bit for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
import jax
from jax.experimental.pallas import tpu as pltpu

from pyisingmontecarlo_tpu.ops import wl_pallas as wp
from pyisingmontecarlo_tpu_torch.ops import wl

torch.set_num_threads(1)

WL_CASES = {
    # name: (input seed, dense, L, beta, gamma, h); R = 2, T = 2; dtau = beta / L
    "ring8 L=5120": (1, ("ring", 8, -1.0), 5120, 256.0, 1.0, 0.1),
    "ring16 L=40960 (row accumulators)": (2, ("ring", 16, -1.0), 40960, 2048.0, 1.0, 0.0),
    "ring4 L=262144 dtau*Gamma=2.7e-6 (lines frozen whole, long runs)": (3, ("ring", 4, 0.7), 262144, 0.7, 1.0,
                                                                          0.2),
}


@pytest.mark.parametrize("name", sorted(WL_CASES))
def test_run_wl_sweeps_equals_jax_kernel(name):
    seed, dense, L, beta, gamma, h = WL_CASES[name]
    nvars = dense[1]
    assert wl.gate(dense, nvars, L, 2) is None
    rng = np.random.default_rng(seed)
    s0 = np.ascontiguousarray(np.broadcast_to((rng.integers(0, 2, (2, nvars, 1)) * 2 - 1).astype(np.int8),
                                              (2, nvars, L)))
    seeds = rng.integers(-(2**31), 2**31, 2).astype(np.int32)
    with pltpu.force_tpu_interpret_mode():
        js, je, _ = wp.run_wl_sweeps_pallas(jnp.asarray(s0), jnp.asarray(seeds), 2, dense, beta, gamma, h, L)
    js, je = np.asarray(js), np.asarray(je)
    ts, te, _ = wl.run_wl_sweeps(torch.from_numpy(s0), seeds, 2, dense, beta, gamma, h, L)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(te, je)
    assert (js != s0).mean() > 0.02, "spins barely moved"
    if "frozen" in name:
        whole = (js == js[:, :, :1]).all(2)
        assert 0 < whole.mean() < 1, f"{whole.mean()} of the lines constant in tau: want some, not all"


@pytest.mark.parametrize("L", (32768 - 32, 32768, 32768 + 32, 40960, 1 << 20))
def test_xla_sum_last_equals_jnp_sum(L):
    rng = np.random.default_rng(L)
    de = np.where(rng.random((3, L)) < 0.5, rng.choice(np.float32([-0.4, -0.0, 0.0, 0.2, 0.3]), (3, L)),
                  0.05 * rng.standard_normal((3, L))).astype(np.float32)
    want = np.asarray(jax.jit(lambda a: jnp.sum(a, axis=0))(de.T))
    np.testing.assert_array_equal(wl.xla_sum_last(torch.from_numpy(de)).numpy(), want)


def _tpu_rule(dense, nvars, ltau):
    """``wl_pallas.supported`` without its platform test."""
    kind, size, _ = dense
    if ltau < 4 or ltau % 2 or nvars % 2 or (kind == "torus" and size % 2):
        return False
    return nvars * ltau * 4 <= wp._MAX_PLANE_BYTES_LARGE


def _grid():
    """Rings and tori on both sides of the plane's edge, of L_tau's parity and
    least value, and of the sites' parity."""
    shapes = []
    for kind, size in (("ring", 4), ("ring", 6), ("ring", 8), ("ring", 16), ("ring", 128), ("ring", 7),
                       ("torus", 4), ("torus", 12), ("torus", 64), ("torus", 5)):
        nvars = size if kind == "ring" else size * size
        edge = wp._MAX_PLANE_BYTES_LARGE // (4 * nvars)
        for L in {2, 3, 4, 5, 6, 4096, 4098, 5120, edge - 2, edge - 1, edge, edge + 1, edge + 2, 2 * edge}:
            if L > 0:
                shapes.append(((kind, size, -1.0), nvars, L))
    return shapes


REPLICAS = (1, 511, 512, 656, 8590, 65536, 10**6)


def test_gate_equals_tpu_rule():
    admitted = 0
    for dense, nvars, L in _grid():
        for R in REPLICAS:
            assert (wl.gate(dense, nvars, L, R) is None) == _tpu_rule(dense, nvars, L), (dense, nvars, L, R)
        admitted += wl.gate(dense, nvars, L) is None
    assert admitted > 20
    assert wl.gate(("ring", 4, -1.0), 4, 1 << 20) is None  # the 4-ring at the gate's edge
    assert wl.gate(("ring", 4, -1.0), 4, (1 << 20) + 2) is not None
    # past 2^31 spins in all (R = 512 at 2^22 spins a replica) and past one launch's 65,535 replicas: the JAX
    # rule reads no R, and the port's wrapper splits the replicas into launches
    for R in REPLICAS:
        assert wl.gate(("ring", 4, -1.0), 4, 1 << 20, R=R) is None
        assert wl.gate(("torus", 64, -1.0), 64 * 64, 800, R=R) is None


def test_ensemble_stays_on_kernel_at_any_replica_count():
    from pyisingmontecarlo_tpu_torch.engines.worldline import WorldlineEnsemble
    from pyisingmontecarlo_tpu_torch.graph import compile_graph
    from pyisingmontecarlo_tpu_torch.rng import key_data_from_seeds

    ring4 = [((i, (i + 1) % 4), -1.0) for i in range(4)]
    kd = key_data_from_seeds(np.arange(512, dtype=np.uint64))
    ens = WorldlineEnsemble(compile_graph(ring4), 1.0, 0.0, 2.0, kd[:511], 511, ltau=1 << 20, device="meta")
    assert ens.s.shape == (511, 4, 1 << 20) and ens.on_kernel()
    ens.append(torch.empty((1, 4, 1 << 20), dtype=torch.int8, device="meta"), kd[511:])
    assert ens.R == 512 and ens.on_kernel()  # 2^31 spins
    big = WorldlineEnsemble(compile_graph(ring4), 1.0, 0.0, 2.0, key_data_from_seeds(np.arange(65600, dtype=np.uint64)),
                            65600, ltau=4100, device="meta")
    assert big.on_kernel()  # past one launch's 65,535 replicas


def test_route_takes_long_lines_to_multi_launch():
    """Past MAX_LTAU neither the resident nor the tiled route takes a line,
    whatever the shared memory; the multi-launch cluster phase leaves one
    block past 26,944 slices on an H100's 232,448 opt-in bytes, and past
    32,768 (its frozen sum's two window levels) on any card."""
    for kind, size, nvars, L in (("ring", 8, 8, 4098), ("ring", 8, 8, 5120), ("torus", 8, 64, 10240),
                                 ("ring", 512, 512, 8192)):
        assert wl.resident_plan(nvars, L, 1, wl.WL_PARAM_BYTES, 1 << 30, 132, None) is None
        assert wl.tiled_plan(kind, size, nvars, L, 1, 1 << 30, 132) is None
        assert wl.choose_route(kind, size, nvars, L, 64, 232448, 132) == ("multi", None)
    assert wl.resident_plan(8, wl.MAX_LTAU, 1, wl.WL_PARAM_BYTES, 232448, 132, None) is not None
    assert [L for L in (26944, 26946) if wl.cluster_long(L, 232448)] == [26946]
    assert [L for L in (32768, 32770) if wl.cluster_long(L, 1 << 20)] == [32770]
