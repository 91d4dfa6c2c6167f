"""The torch port's ladder sweep (``ops/ladder.py``) against the JAX package's
Pallas ladder kernel (``wl_ladder_pallas.ladder_sweep``) in interpret mode:
final spins from the same numpy-made states and per-sweep seeds (split from a
numpy threefry key chain), on a ring with a field, with per-replica dyadic
coupling overrides and missing edges, on a +-J torus, with frozen time lines
at Gamma = 0.05, and at L_tau = 40 and 72 (a frozen line's total crosses the
32-slice windows of XLA's summation order). Also the host planes, the
topology detector, the f32 parameters, and the gate and argument checks.

Spins must be equal (tolerance: none). The one known source of a difference
is the last ulp of an f32 ``log`` (XLA's against torch's) or of an FMA that
XLA's CPU code forms, in a decision whose two sides fall within it. On the
CPU the wrapper runs the plain version; ``chip_smoke.py`` holds the CUDA
kernel to it on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")
from jax.experimental.pallas import tpu as pltpu

from pyisingmontecarlo_tpu.engines import worldline as jwl
from pyisingmontecarlo_tpu.graph import grid_2d_edges
from pyisingmontecarlo_tpu.ops import wl_ladder_pallas as wlp
from pyisingmontecarlo_tpu_torch import graph as tgraph
from pyisingmontecarlo_tpu_torch import rng as trng
from pyisingmontecarlo_tpu_torch.engines import worldline as twl
from pyisingmontecarlo_tpu_torch.ops import ladder

torch.set_num_threads(1)


def _ring(n):
    return np.arange(n), (np.arange(n) + 1) % n


def _torus(m):
    g = grid_2d_edges(m, m)
    return np.array([a for (a, _), _ in g]), np.array([b for (_, b), _ in g])


def _seed_table(seed, R, T):
    """Initial key data and per-sweep kernel seeds [T, R] from a key chain."""
    kd = trng.key_data_from_seeds(np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64))
    k0, seeds = kd, []
    for _ in range(T):
        kd, sub = trng.split_all(kd)
        seeds.append(trng.seeds_from_key_data(sub))
    return k0, np.stack(seeds)


def _dyadic_overrides(R, E, seed):
    """Per-replica couplings in {+-1, +-0.5}, about a quarter missing (J = 0)."""
    rng = np.random.default_rng(seed)
    jv = rng.choice([-1.0, -0.5, 0.5, 1.0], (R, E))
    return np.where(rng.random((R, E)) < 0.25, 0.0, jv)


# name, kind, size, (edge_a, edge_b), J ([E] or [R, E]), betas, gammas, hs, L, T
CASES = [
    ("ring8 h", "ring", 8, _ring(8), np.full(8, -1.0), [0.5, 1.0, 1.5, 2.0], [1.0] * 4,
     [0.3, 0.3, -0.2, 0.1], 40, 4),
    ("ring8 dyadic overrides", "ring", 8, _ring(8), _dyadic_overrides(4, 8, 1), [0.8, 1.0, 1.2, 1.4],
     [1.0, 0.9, 1.0, 1.1], [0.0, 0.2, 0.0, -0.3], 40, 4),
    ("torus4 +-J", "torus", 4, _torus(4), np.random.default_rng(2).choice([-1.0, 1.0], 32), [0.6, 1.2],
     [1.0, 0.7], [0.2, -0.1], 40, 3),
    ("frozen lines Gamma=0.05", "ring", 8, _ring(8), np.full(8, 0.7), [2.0, 2.0, 1.0], [0.05] * 3,
     [0.2, -0.1, 0.0], 40, 3),
    ("L_tau=72 frozen totals", "ring", 6, _ring(6), np.full(6, -1.0), [3.6, 3.6], [0.05, 0.1],
     [0.1, 0.0], 72, 3),
    ("torus4 dyadic overrides L_tau=72", "torus", 4, _torus(4), _dyadic_overrides(2, 32, 3), [3.6, 3.0],
     [0.3, 0.2], [0.0, 0.5], 72, 2),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_sweeps_equal_jax_kernel(case):
    name, kind, size, (ea, eb), jv, betas, gammas, hs, L, T = case
    nvars = size if kind == "ring" else size * size
    R = len(betas)
    kd, seeds = _seed_table(len(name), R, T)
    s0 = np.ascontiguousarray(np.broadcast_to(trng.random_states(kd, nvars)[:, :, None], (R, nvars, L)))
    jp = wlp.build_planes(kind, size, nvars, ea, eb, jv, betas, gammas, hs, L)
    s = jnp.asarray(s0)
    with pltpu.force_tpu_interpret_mode():
        for t in range(T):
            s = wlp.ladder_sweep(s, jnp.asarray(seeds[t]), jp, kind, size, nvars)
    want = np.asarray(s)
    planes = ladder.build_planes(kind, size, nvars, ea, eb, jv, betas, gammas, hs, L)
    edges = tuple(torch.from_numpy(np.asarray(e, np.int32)) for e in (ea, eb))
    got = ladder.ladder_sweeps(torch.from_numpy(s0), torch.from_numpy(seeds), planes, T, edges)[0].numpy()
    diff = np.argwhere(want != got)
    assert len(diff) == 0, f"{len(diff)} of {want.size} spins differ; first at {diff[:8].tolist()}"
    assert (got != s0).mean() > 0.05, "too few spins moved to test anything"
    if "frozen" in name:  # most lines one cluster: the frozen-line total decides them
        assert (got == got[:, :, :1]).all(2).mean() > 0.5


@pytest.mark.parametrize("kind,size,overrides", [("ring", 8, False), ("ring", 8, True), ("torus", 4, False),
                                                 ("torus", 4, True), ("torus", 6, True)])
def test_build_planes_equal_jax(kind, size, overrides):
    nvars = size if kind == "ring" else size * size
    ea, eb = _ring(size) if kind == "ring" else _torus(size)
    R = 3
    jv = _dyadic_overrides(R, len(ea), size) if overrides else np.linspace(-1.0, 1.0, len(ea))
    betas, gammas, hs = np.geomspace(0.2, 3.0, R), [1.0, 0.3, 2.0], [0.1, 0.0, -0.7]
    want = wlp.build_planes(kind, size, nvars, ea, eb, jv, betas, gammas, hs, 60)
    got = ladder.build_planes(kind, size, nvars, ea, eb, jv, betas, gammas, hs, 60)
    assert got.j.shape == (R, 1 if kind == "ring" else 2, nvars) and got.j.dtype == torch.float32
    for d, jplane in enumerate(want[0]):
        np.testing.assert_array_equal(got.j[:, d].reshape(1, -1).numpy(), np.asarray(jplane))
    for name, plane in zip(("dt", "kt", "h", "pb"), want[1:]):
        np.testing.assert_array_equal(np.repeat(getattr(got, name).numpy(), nvars)[None], np.asarray(plane))


def test_detect_topology_equals_jax():
    cases = [(n, *_ring(n)) for n in (3, 4, 5, 6, 8, 9, 16)]
    for m in (2, 3, 4, 6):
        ea, eb = _torus(m)
        cases += [(m * m, ea, eb), (m * m, ea[:-1], eb[:-1]), (m * m, eb, ea)]
    cases.append((8, np.array([0, 1]), np.array([1, 2])))
    seen = set()
    for n, ea, eb in cases:
        got = tgraph.detect_topology(n, ea, eb)
        assert got == wlp.detect_topology(n, ea, eb), (n, ea, eb)
        seen.add(None if got is None else got[0])
    assert seen == {None, "ring", "torus"}


def test_make_params_equal_jax():
    """dtau, gamma, h and beta are f32 math as in JAX (equal); ktau is an f32
    log of an f32 tanh, and the two libraries' may differ in the last ulp."""
    b, g, h = np.geomspace(0.2, 3.0, 64), np.linspace(0.5, 1.5, 64), np.linspace(-0.3, 0.3, 64)
    want = jwl.make_params(b, g, h, 60)
    got = twl.make_params(b, g, h, 60)
    for name in ("dtau", "gamma", "h", "beta"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_allclose(got.ktau.numpy(), np.asarray(want.ktau), rtol=2.5e-7)


def test_gate_rejects():
    assert ladder.gate(("ring", 8), 8, 40, 64) is None
    assert "ring or square torus" in ladder.gate(None, 8, 40)
    for L in (2, 41, ladder.MAX_POINTS // 8 + 2):
        assert "L_tau" in ladder.gate(("ring", 8), 8, L)
    assert "not even" in ladder.gate(("torus", 3), 9, 40)
    # the JAX gate reads no replica count, nor does the port's: 2^16 replicas of 32,768 spins run in chunks
    assert ladder.gate(("ring", 8), 8, 4096, 2**16) is None


def test_wrapper_checks():
    ea, eb = _ring(8)
    planes = ladder.build_planes("ring", 8, 8, ea, eb, np.ones(8), [1.0, 2.0], [1.0, 1.0], [0.0, 0.0], 8)
    s = torch.ones((2, 8, 8), dtype=torch.int8)
    seeds = torch.zeros((3, 2), dtype=torch.int32)
    edges = tuple(torch.from_numpy(np.asarray(e, np.int32)) for e in (ea, eb))
    assert torch.equal(ladder.ladder_sweeps(s, seeds[:0], planes, 0, edges)[0], s)
    with pytest.raises(ValueError, match="int8"):
        ladder.ladder_sweeps(s.to(torch.int32), seeds, planes, 3, edges)
    with pytest.raises(ValueError, match="planes are for"):
        ladder.ladder_sweeps(torch.ones((2, 8, 10), dtype=torch.int8), seeds, planes, 3, edges)
    with pytest.raises(ValueError, match="seeds"):
        ladder.ladder_sweeps(s, seeds, planes, 2, edges)
    with pytest.raises(ValueError, match="planes.dt"):
        ladder.ladder_sweeps(s, seeds, planes._replace(dt=planes.dt.double()), 3, edges)
    with pytest.raises(ValueError, match="contiguous"):
        ladder.ladder_sweeps(s.transpose(1, 2).contiguous().transpose(1, 2), seeds, planes, 3, edges)
