#!/usr/bin/env python3
"""Drive the torch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases, each printing at least one line; any failure raises and exits non-zero:

1.  gpu           the card's name and power limit (nvidia-smi);
2.  build         nvcc builds the CUDA kernels from ``pyisingmontecarlo_tpu_torch/csrc``;
3.  compare       the square-torus kernel vs its plain PyTorch version on the
                  card, bit for bit (annealing, field, explicit randoms,
                  sampling, bench shape);
4.  main          ``Lattice.run_monte_carlo`` at 1024^2, 8 replicas, 1024
                  sweeps, through the kernel (2 launches per sweep);
5.  physics       Onsager energy (L=32) and disordered magnetization (L=16);
6.  timing        square-torus kernel and plain version at the bench shape;
7.  compare-wl    the worldline kernel vs its plain version, bit for bit
                  (ring, torus with field, frozen rings, long L_tau, sampling,
                  and the 256^2 x 8 x 40 main shape);
8.  main-quantum  ``Lattice.run_quantum_monte_carlo(2.0, 200, 8)`` on the
                  256^2 TFIM torus (the shape of benches/bench_qmc_large.py);
9.  main-chain    ``Lattice.run_quantum_monte_carlo_sampling`` on the 256-site
                  TFIM chain, 64 replicas, 500 + 2000 sweeps (benches/bench_qmc.py's
                  shape), against the exact free-fermion energy;
10. physics-wl    <E> of a 6-ring against dense diagonalization, and a bond
                  autocorrelation on a 32^2 torus;
11. timing-wl     worldline kernel and plain version at both main shapes, and
                  each launch's device time (torch.profiler);
12. compare-ladder    the tempering ladder kernel vs its plain version, bit
                  for bit (ring with field and per-replica couplings, 12^2 +-J
                  torus, frozen lines, L_tau=1200, the 64 x 144 x 60 bench shape);
13. main-tempering    ``LatticeTempering.qmc_timesteps_sample`` at t = 500, then
                  2000, on the ladder of benches/bench_tempering.py (12^2 +-J
                  spin glass, 64 replicas, L_tau = 60; 6 launches per sweep),
                  with sweeps/s and swap attempts/s as that bench takes them;
14. physics-tempering per-rung <E> of a 4-ring ladder against dense diagonalization;
15. timing-ladder     ladder kernel and plain version at the bench shape, each
                  launch's device time and the idle share over whole tempering
                  steps (torch.profiler), and the kernel on a 64^2 +-J torus.

Then one JSON line with the kernels, and last ``{"ok": true, "device": ...}``.
Needs torch with CUDA, nvcc and numpy; imports no jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
BENCH_L, BENCH_R, BENCH_BETA = 1024, 8, 0.4
# the worldline main shapes: the 256^2 torus (8 replicas) and the 256-site
# chain (64 replicas), both at beta=2, Gamma=1, J=-1, so L_tau = 40
WL_BETA, WL_GAMMA, WL_LTAU = 2.0, 1.0, 40
TORUS = (("torus", 256, -1.0), 256 * 256, 8)
CHAIN = (("ring", 256, -1.0), 256, 64)

# Least time of a kernel's work on an H100 SXM: the bytes it must move at the
# 3.35 TB/s of HBM3, or its integer operations at 33.5 T int32 op/s (the
# H100 white paper; 64 int32 lanes per SM, half the fp32 rate). A lane-hash
# draw is 22 integer operations (ops/lanerng.py); a square-torus site update
# adds 8 (neighbour sum, table index, compare, select); a worldline spin takes
# two draws per sweep (site phase and time bond) and 18 more operations
# (site test, cluster dE and run sum, accumulation). Cluster-head draws,
# which depend on the data, are not counted, so the bound is a lower one.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 33.5e12
F32_OPS_PER_S = 67e12  # outside the tensor cores (the H100 SXM data sheet)
HASH_OPS = 22
SQ2D_OPS_PER_SITE = HASH_OPS + 8
WL_OPS_PER_SPIN = 2 * HASH_OPS + 18
# A ladder spin per sweep (csrc/ladder.cu): two draws (site phase, time bond)
# and about 10 more integer operations (indices, alignment, bits); in f32 the
# site phase's field, dE, uniform and logit (about 20 operations plus two
# logf) and the cluster phase's uniform, bond test, field, slice dE and run
# sum (about 17). A logf counts 10 f32 operations (range reduction and
# polynomial). Cluster-head draws and logs depend on the data and are not
# counted, so the bound is a lower one.
LOG_OPS = 10
LADDER_INT_OPS_PER_SPIN = 2 * HASH_OPS + 10
LADDER_F32_OPS_PER_SPIN = 37 + 2 * LOG_OPS
# the tempering ladder of benches/bench_tempering.py (the BASELINE.json
# "Parallel tempering" config): 12^2 periodic +-J spin glass, 64 replicas at
# geomspace(0.2, 3.0), Gamma = 1, h = 0, so L_tau = 60
PT_SIDE, PT_R, PT_LTAU = 12, 64, 60


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def onsager_u(beta):
    """Exact internal energy per site of the 2D Ising ferromagnet (J=-1)."""
    k = 2.0 * np.sinh(2 * beta) / np.cosh(2 * beta) ** 2
    a, b = 1.0, np.sqrt(1.0 - k * k)
    while abs(a - b) > 1e-15:
        a, b = (a + b) / 2.0, np.sqrt(a * b)
    K = np.pi / (2.0 * a)
    return -1.0 / np.tanh(2 * beta) * (1.0 + (2.0 / np.pi) * (2.0 * np.tanh(2 * beta) ** 2 - 1.0) * K)


def bound(nbytes, ops, f32_ops=0):
    """(least ms, what sets it) for ``nbytes`` moved, ``ops`` integer and
    ``f32_ops`` f32 operations: the larger of the three times."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / INT32_OPS_PER_S, f32_ops / F32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts():
    from pyisingmontecarlo_tpu_torch.ops import ladder, sq2d, wl

    sq2d.sweeps_2d.launches = 0
    wl.wl_sweeps.launches = 0
    ladder.ladder_sweeps.launches = 0


def read_counts():
    from pyisingmontecarlo_tpu_torch.ops import ladder, sq2d, wl

    return {"sq2d": sq2d.sweeps_2d.launches, "wl": wl.wl_sweeps.launches, "ladder": ladder.ladder_sweeps.launches}


def phase_gpu():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
    if not (HERE / "pyisingmontecarlo_tpu_torch" / "csrc").is_dir():
        sys.exit(f"chip_smoke: run from the root of a checkout (no pyisingmontecarlo_tpu_torch beside {__file__})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    return smi


def phase_build():
    from pyisingmontecarlo_tpu_torch import _kernels

    t0 = time.perf_counter()
    path = _kernels.build(verbose=True)
    _kernels.load()
    dt = time.perf_counter() - t0
    print(f"build: {dt:.3f} s, {path.relative_to(HERE)}", flush=True)


def _inputs(L, R, seed, dev):
    from pyisingmontecarlo_tpu_torch.ops.lattice2d import random_states_2d
    from pyisingmontecarlo_tpu_torch.rng import replica_seeds_i32

    u64 = np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64)
    seeds = torch.from_numpy(replica_seeds_i32(u64)).to(dev)
    return random_states_2d(seeds, L), seeds


def phase_compare(dev):
    """Kernel vs plain version on the card; returns the largest |difference|."""
    from pyisingmontecarlo_tpu_torch.ops import sq2d

    rng = np.random.default_rng(0)
    cases = []
    s, seeds = _inputs(64, 4, 1, dev)
    sched = np.interp(np.arange(37), [0, 36], [0.1, 1.0]).astype(np.float32)
    cases.append(("anneal L=64 R=4 J=-1 h=0 T=37", s, seeds, sq2d.thresholds(sched, -1.0, 0.0), 3, {}))
    s, seeds = _inputs(64, 4, 2, dev)
    cases.append(("field L=64 R=4 J=0.5 h=-0.3 T=20", s, seeds,
                  sq2d.thresholds(np.full(20, 0.7, np.float32), 0.5, -0.3), 0, {}))
    s, seeds = _inputs(64, 2, 3, dev)
    rb = torch.from_numpy(rng.integers(0, 2**31, (12, 64, 32), dtype=np.int64).astype(np.int32)).to(dev)
    cases.append(("explicit rb L=64 R=2 T=6", s, seeds,
                  sq2d.thresholds(np.full(6, 0.5, np.float32), -1.0, 0.2), 0, dict(rb=rb)))
    s, seeds = _inputs(64, 4, 4, dev)
    cases.append(("sampling L=64 R=4 freq=5 T=23", s, seeds,
                  sq2d.thresholds(np.full(23, 0.44, np.float32), -1.0, 0.0), 100, dict(samples=5)))
    s, seeds = _inputs(BENCH_L, BENCH_R, 5, dev)
    cases.append((f"bench L={BENCH_L} R={BENCH_R} beta={BENCH_BETA} T=64", s, seeds,
                  sq2d.thresholds(np.full(64, BENCH_BETA, np.float32), -1.0, 0.0), 0, {}))
    worst = 0
    for name, s, seeds, thr, ctr0, kw in cases:
        thr = thr.to(dev)
        got = sq2d.sweeps_2d(s, seeds, thr, ctr0, **kw)
        want = sq2d.sweeps_2d_reference(s, seeds, thr, ctr0, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = max(int((g.to(torch.int32) - w.to(torch.int32)).abs().max().item()) for g, w in zip(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"{name}: kernel != plain (max |diff| {err})")
        check(not torch.equal(got[0], s), f"{name}: no spin moved")
        worst = max(worst, err)
        print(f"compare: {name}: bit-identical ({sum(g.numel() for g in got)} spins)", flush=True)
    return worst


def phase_main(dev):
    """The main path through the user's entry point; returns the launch count."""
    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
    from pyisingmontecarlo_tpu_torch.ops import lattice2d

    T = 1024
    lat = Lattice(grid_2d_edges(BENCH_L, BENCH_L, -1.0), seed_gen=0, device=dev)
    check(lat._torus == (BENCH_L, -1.0), "the bench lattice is not detected as a torus")
    reset_counts()
    t0 = time.perf_counter()
    es, st = lat.run_monte_carlo(BENCH_BETA, T, BENCH_R)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    launches = counts["sq2d"]
    check(launches == 2 * T and counts["wl"] == 0 and counts["ladder"] == 0,
          f"launch counts {counts}, want sq2d {2 * T}")
    check(es.shape == (BENCH_R,) and es.dtype == np.float64, f"energies {es.shape} {es.dtype}")
    check(st.shape == (BENCH_R, BENCH_L * BENCH_L) and st.dtype == np.bool_, f"states {st.shape} {st.dtype}")
    check(np.isfinite(es).all(), "non-finite energies")
    s = torch.from_numpy(np.where(st, 1, -1).astype(np.int8).reshape(BENCH_R, BENCH_L, BENCH_L)).to(dev)
    again = lattice2d.energy_2d(s, -1.0, 0.0).cpu().numpy().astype(np.float64)
    check(np.array_equal(es, again), "energies != energy_2d(states)")
    u = es.mean() / BENCH_L**2
    check(abs(u - onsager_u(BENCH_BETA)) < 0.01, f"u={u} vs Onsager {onsager_u(BENCH_BETA)}")
    print(f"main: Lattice.run_monte_carlo({BENCH_BETA}, {T}, {BENCH_R}) at {BENCH_L}^2: "
          f"{launches} launches, {dt:.3f} s host wall, u={u:.6f} (Onsager {onsager_u(BENCH_BETA):.6f})", flush=True)
    return launches


def phase_physics(dev):
    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges

    L = 32
    lat = Lattice(grid_2d_edges(L, L, -1.0), seed_gen=3, device=dev)
    out = []
    for beta in (0.35, 0.60):
        es, _ = lat.run_monte_carlo_sampling(beta, 200, 16, thermalization_time=1000, sampling_freq=20)
        u = es.mean() / L**2
        se = es.mean(axis=1).std(ddof=1) / np.sqrt(es.shape[0]) / L**2
        check(abs(u - onsager_u(beta)) < 5 * se + 0.008, f"beta={beta}: u={u} vs {onsager_u(beta)}, se={se}")
        out.append(f"beta={beta} u={u:.5f} (Onsager {onsager_u(beta):.5f}, se {se:.5f})")
    lat = Lattice(grid_2d_edges(16, 16, -1.0), seed_gen=0, device=dev)
    _, ss = lat.run_monte_carlo_sampling(0.30, 60, 24, thermalization_time=800, sampling_freq=25)
    m = np.abs(np.where(ss, 1.0, -1.0).mean(axis=2)).mean()
    check(m < 0.2, f"L=16 beta=0.30: |m|={m}")
    out.append(f"L=16 beta=0.30 |m|={m:.4f}")
    print("physics: " + "; ".join(out), flush=True)


def in_turns(run_kernel, run_plain, n_kernel, n_plain):
    """Milliseconds per sweep of each call, timed with CUDA events in the order
    plain, kernel, kernel, plain; returns (kernel runs, plain runs)."""
    runs = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn, n = (run_kernel, n_kernel) if name == "kernel" else (run_plain, n_plain)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        runs[name].append(start.elapsed_time(end) / n)
    return runs["kernel"], runs["plain"]


def phase_timing(dev, smi):
    """Kernel and plain version at the bench shape, in turns, then the kernel's
    sampling and explicit-randoms modes (TPU kernels 2 and 3) at the same
    shape; returns (kernel ms per sweep, plain ms per sweep)."""
    from pyisingmontecarlo_tpu_torch.ops import sq2d

    T, L, sites = 1024, BENCH_L, BENCH_R * BENCH_L**2
    s, seeds = _inputs(L, BENCH_R, 6, dev)
    thr = sq2d.thresholds(np.full(T, BENCH_BETA, np.float32), -1.0, 0.0).to(dev)
    for fn in (sq2d.sweeps_2d, sq2d.sweeps_2d_reference):  # warm-up
        fn(s, seeds, thr[:8], 0)
    k, p = in_turns(lambda: sq2d.sweeps_2d(s, seeds, thr, 0), lambda: sq2d.sweeps_2d_reference(s, seeds, thr, 0),
                    T, T)
    ms, plain_ms = float(np.mean(k)), float(np.mean(p))
    print(f"timing: {L}^2 x {BENCH_R} replicas, beta={BENCH_BETA}, {T} sweeps, on {smi}: "
          f"kernel {ms:.5f} ms/sweep = {sites / (ms * 1e6):.3f} attempted flips/ns (runs {k}); "
          f"plain torch {plain_ms:.5f} ms/sweep = {sites / (plain_ms * 1e6):.3f} flips/ns (runs {p})", flush=True)
    T2 = 64
    rb = torch.randint(0, 2**31 - 1, (2 * T2, L, L // 2), dtype=torch.int32, device=dev)
    for mode, kw, nbytes, ops in (
        ("sampling, a sample every 16 sweeps", dict(samples=16), 2 * sites / T2 + sites / 16,
         SQ2D_OPS_PER_SITE * sites),
        ("explicit randoms", dict(rb=rb), 2 * sites / T2 + 4 * L * L, (SQ2D_OPS_PER_SITE - HASH_OPS) * sites),
    ):
        k, p = in_turns(lambda: sq2d.sweeps_2d(s, seeds, thr[:T2], 0, **kw),
                        lambda: sq2d.sweeps_2d_reference(s, seeds, thr[:T2], 0, **kw), T2, T2)
        b_ms, b_by = bound(nbytes, ops)
        print(f"timing: {mode}, {L}^2 x {BENCH_R}, {T2} sweeps: kernel {np.mean(k):.5f} ms/sweep (runs {k}); "
              f"plain torch {np.mean(p):.5f} ms/sweep (runs {p}); bound {b_ms:.5f} ms/sweep ({b_by})", flush=True)
    return ms, plain_ms


def _wl_inputs(dense, nvars, R, seed, dev, ltau=WL_LTAU):
    """Random worldlines constant along tau (as a fresh run starts) and seeds."""
    from pyisingmontecarlo_tpu_torch.rng import key_data_from_seeds, random_states, seeds_from_key_data

    u64 = np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64)
    kd = key_data_from_seeds(u64)
    s = torch.from_numpy(random_states(kd, nvars)).to(dev)[:, :, None].expand(R, nvars, ltau).contiguous()
    return s, torch.from_numpy(seeds_from_key_data(kd)).to(dev)


def phase_compare_wl(dev):
    """Worldline kernel vs plain version on the card; returns the largest |difference|."""
    from pyisingmontecarlo_tpu_torch.ops import wl

    cases = [  # name, dense, nvars, R, L_tau, T, beta, gamma, h, freq, nsamples
        ("ring 256 R=4 L=40 T=13", ("ring", 256, -1.0), 256, 4, 40, 13, 2.0, 1.0, 0.0, 0, 0),
        ("torus 16^2 R=2 h=-0.3 T=9", ("torus", 16, -1.0), 256, 2, 40, 9, 2.0, 1.0, -0.3, 0, 0),
        ("frozen rings: ring 64 R=4 Gamma=0.05 h=0.2 T=9", ("ring", 64, 0.7), 64, 4, 40, 9, 2.0, 0.05, 0.2, 0, 0),
        ("long L_tau=1200 (two-level frozen sums) ring 32 R=2 T=5", ("ring", 32, -1.0), 32, 2, 1200, 5,
         60.0, 0.05, 0.1, 0, 0),
        ("sampling chain 256 R=64 freq=3 nsamples=4 rem=2", CHAIN[0], 256, 64, 40, 14, 2.0, 1.0, 0.0, 3, 4),
        ("main torus 256^2 R=8 L=40 T=4", TORUS[0], TORUS[1], TORUS[2], 40, 4, WL_BETA, WL_GAMMA, 0.0, 0, 0),
    ]
    worst = 0
    for k, (name, dense, nvars, R, L, T, beta, gamma, h, freq, ns) in enumerate(cases):
        s, seeds = _wl_inputs(dense, nvars, R, 100 + k, dev, L)
        tables = wl.make_tables(dense, nvars, beta, gamma, h, L, dev)
        got = wl.wl_sweeps(s, seeds, tables, T, freq, ns)
        want = wl.wl_sweeps_reference(s, seeds, tables, T, freq, ns)
        torch.cuda.synchronize()
        err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()) if g.numel() else 0
                  for g, w in zip(got, want))
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"{name}: kernel != plain (max |diff| {err})")
        moved = float((got[0] != s).float().mean())
        check(moved > 0.05, f"{name}: only {moved:.4f} of the spins moved")
        frozen = float((got[0] == got[0][:, :, :1]).all(2).float().mean())
        worst = max(worst, err)
        print(f"compare-wl: {name}: bit-identical (spins, statistics{', samples' if ns else ''}); "
              f"{moved:.3f} of spins moved, {frozen:.3f} of lines constant in tau", flush=True)
    return worst


def phase_main_quantum(dev):
    """The worldline path through the user's entry point at the 256^2 torus;
    returns the launch count."""
    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch.engines.worldline import choose_ltau
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
    from pyisingmontecarlo_tpu_torch.ops import wl

    T, (dense, nvars, R) = 200, TORUS
    lat = Lattice(grid_2d_edges(256, 256, -1.0), seed_gen=0, device=dev)
    lat.set_transverse_field(WL_GAMMA)
    check(choose_ltau(WL_BETA, WL_GAMMA) == WL_LTAU, "L_tau")
    reset_counts()
    t0 = time.perf_counter()
    es, st = lat.run_quantum_monte_carlo(WL_BETA, T, R)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    check(counts == {"sq2d": 0, "wl": wl.LAUNCHES_PER_SWEEP * T, "ladder": 0},
          f"launch counts {counts}, want wl {wl.LAUNCHES_PER_SWEEP * T}")
    check(es.shape == (R,) and es.dtype == np.float64, f"energies {es.shape} {es.dtype}")
    check(st.shape == (R, nvars) and st.dtype == np.bool_, f"states {st.shape} {st.dtype}")
    check(np.isfinite(es).all(), "non-finite energies")
    e = es.mean() / nvars
    # the ground state is near -2.13 per site; 200 sweeps from a random start
    # leave domain walls, which cost at most a few tenths per site
    check(-2.5 < e < -1.0, f"e/site {e} outside (-2.5, -1.0)")
    print(f"main-quantum: Lattice.run_quantum_monte_carlo({WL_BETA}, {T}, {R}) on the 256^2 torus, "
          f"L_tau={WL_LTAU}: {counts['wl']} launches, {dt:.3f} s host wall, e/site={e:.6f}", flush=True)
    return counts["wl"]


def chain_energy(n, beta, gamma, j=1.0):
    """<E>/site of the periodic TFIM ring -J sum sz sz - Gamma sum sx (n even),
    exactly, from its free fermions: Z = (Z_A+ + Z_A- + Z_P+ - Z_P-) / 2 over
    the antiperiodic (k = 2 pi (m + 1/2) / n) and periodic (k = 2 pi m / n)
    modes, with Z_X+ = prod 2 cosh(beta e_k / 2), Z_X- = prod 2 sinh(beta e_k / 2),
    e_k = 2 sqrt(J^2 + Gamma^2 - 2 J Gamma cos k), and the periodic zero mode
    signed, e_0 = 2 (Gamma - J); <E> = -d ln Z / d beta by a central difference.
    phase_physics_wl checks it against dense diagonalization."""
    def ln_z(b):
        ea = 2 * np.sqrt(j * j + gamma * gamma - 2 * j * gamma * np.cos(2 * np.pi * (np.arange(n) + 0.5) / n))
        ep = 2 * np.sqrt(j * j + gamma * gamma - 2 * j * gamma * np.cos(2 * np.pi * np.arange(n) / n))
        ep[0] = 2 * (gamma - j)
        sinh_p = np.sinh(b * ep / 2)
        logs = [np.log(2 * np.cosh(b * ea / 2)).sum(), np.log(2 * np.abs(np.sinh(b * ea / 2))).sum(),
                np.log(2 * np.cosh(b * ep / 2)).sum(), np.log(np.maximum(2 * np.abs(sinh_p), 1e-300)).sum()]
        top = max(logs)
        w = [np.exp(x - top) for x in logs]
        return np.log(0.5 * (w[0] + w[1] + w[2] - np.prod(np.sign(sinh_p)) * w[3])) + top

    d = 1e-5
    return float(-(ln_z(beta + d) - ln_z(beta - d)) / (2 * d) / n)


def phase_main_chain(dev):
    """The sampling path through the user's entry point on the 256-site chain;
    returns the launch count."""
    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch.ops import wl

    (dense, n, R), T, wait, freq = CHAIN, 2000, 500, 10
    lat = Lattice([((i, (i + 1) % n), -1.0) for i in range(n)], seed_gen=0, device=dev)
    lat.set_transverse_field(WL_GAMMA)
    reset_counts()
    t0 = time.perf_counter()
    es, ss = lat.run_quantum_monte_carlo_sampling(WL_BETA, T, R, sampling_wait_buffer=wait, sampling_freq=freq)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = wl.LAUNCHES_PER_SWEEP * (wait + T)
    check(counts == {"sq2d": 0, "wl": want, "ladder": 0}, f"launch counts {counts}, want wl {want}")
    check(es.shape == (R,) and es.dtype == np.float64 and np.isfinite(es).all(), f"energies {es.shape} {es.dtype}")
    check(ss.shape == (R, T // freq, n) and ss.dtype == np.bool_, f"samples {ss.shape} {ss.dtype}")
    e, se = es.mean() / n, es.std(ddof=1) / np.sqrt(R) / n
    exact = chain_energy(n, WL_BETA, WL_GAMMA)
    # 4 standard errors plus the Trotter allowance of tests/test_worldline_exact.py
    check(abs(e - exact) < 4 * se + 0.03, f"e/site {e} vs exact {exact} (se {se})")
    m = np.abs(np.where(ss, 1.0, -1.0).mean(axis=2)).mean()
    print(f"main-chain: Lattice.run_quantum_monte_carlo_sampling({WL_BETA}, {T}, {R}, wait={wait}, freq={freq}) "
          f"on the 256-chain: {counts['wl']} launches, {dt:.3f} s host wall, e/site={e:.6f} "
          f"(exact {exact:.6f}, se {se:.6f}), <|m|> of the samples {m:.4f}", flush=True)
    return counts["wl"]


def dense_tfim_energy(edges, h, gamma, beta, nvars):
    """<E> of H = sum J sz sz + h sum sz - Gamma sum sx by dense diagonalization."""
    dim = 2**nvars
    H = np.zeros((dim, dim))
    st = np.arange(dim)
    sz = [1.0 - 2.0 * ((st >> i) & 1) for i in range(nvars)]
    H[st, st] = sum(j * sz[a] * sz[b] for (a, b), j in edges) + h * sum(sz)
    for i in range(nvars):
        H[st ^ (1 << i), st] += -gamma
    w = np.linalg.eigvalsh(H)
    zw = np.exp(-beta * (w - w.min()))
    return float((w * zw).sum() / zw.sum())


def phase_physics_wl(dev):
    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges

    edges = [((i, (i + 1) % 6), -1.0) for i in range(6)]
    exact = dense_tfim_energy(edges, 0.0, 1.0, 2.0, 6)
    check(abs(6 * chain_energy(6, 2.0, 1.0) - exact) < 1e-6, "free-fermion ring energy != dense diagonalization")
    lat = Lattice(edges, seed_gen=1, device=dev)
    lat.set_transverse_field(1.0)
    es, _ = lat.run_quantum_monte_carlo_sampling(2.0, 220, 96, sampling_wait_buffer=150)
    m, se = es.mean(), es.std(ddof=1) / np.sqrt(len(es))
    check(abs(m - exact) < 4 * se + 0.03, f"6-ring <E>={m} vs dense {exact} (se {se})")
    lat = Lattice(grid_2d_edges(32, 32, -1.0), seed_gen=13, device=dev)
    lat.set_transverse_field(1.0)
    t0 = time.perf_counter()
    rho = lat.run_quantum_monte_carlo_and_measure_bond_autocorrelation(2.0, 1000, 64, sampling_wait_buffer=200)
    dt = time.perf_counter() - t0
    check(rho.shape == (64, 1000) and np.isfinite(rho).all(), f"bond autocorrelation {rho.shape}")
    check(np.abs(rho[:, 0] - 1.0).max() < 1e-5, "rho(0) != 1")
    print(f"physics-wl: 6-ring beta=2 Gamma=1 <E>={m:.5f} (dense {exact:.5f}, se {se:.5f}); "
          f"32^2 torus bond autocorrelation (2.0, 1000, 64, wait 200): rho(0)=1, rho(1)={rho[:, 1].mean():.4f}, "
          f"rho(10)={rho[:, 10].mean():.4f}, {dt:.3f} s host wall", flush=True)


def _device_times(prof, names, everything=False):
    """({kernel: [us of each launch]}, busy us, span us) of the device
    activity a torch.profiler run recorded: the kernels whose names contain
    one of ``names``, or with ``everything`` all of it (the rest as "other");
    None when it recorded no device time."""
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name and (everything or any(n in e.name for n in names))]
    if not evs:
        return None
    per = {}
    for e in evs:
        name = next((n for n in names if n in e.name), "other")
        per.setdefault(name, []).append(e.time_range.elapsed_us())
    busy = sum(sum(v) for v in per.values())
    span = max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)
    return per, busy, span


def phase_timing_wl(dev, smi):
    """Kernel and plain version at both main shapes (the torus in plain mode,
    the chain in sampling mode), plain-kernel-kernel-plain with CUDA events;
    then each launch's device time from torch.profiler. Returns
    {shape: (kernel ms/sweep, plain ms/sweep, bound ms/sweep, bound_by)}."""
    from pyisingmontecarlo_tpu_torch.ops import wl

    out = {}
    for key, (dense, nvars, R), freq, T, T_plain in (("torus", TORUS, 0, 200, 3), ("chain", CHAIN, 10, 2000, 20)):
        s, seeds = _wl_inputs(dense, nvars, R, 7, dev)
        tables = wl.make_tables(dense, nvars, WL_BETA, WL_GAMMA, 0.0, WL_LTAU, dev)
        for fn in (wl.wl_sweeps, wl.wl_sweeps_reference):  # warm-up
            fn(s, seeds, tables, 2, freq, 2 // freq if freq else 0)
        k, p = in_turns(lambda: wl.wl_sweeps(s, seeds, tables, T, freq, T // freq if freq else 0),
                        lambda: wl.wl_sweeps_reference(s, seeds, tables, T_plain, freq, T_plain // freq if freq else 0),
                        T, T_plain)
        times = {"kernel": k, "plain": p}
        ms = {name: float(np.mean(v)) for name, v in times.items()}
        spins = R * nvars * WL_LTAU
        nbytes = 2 * spins + (R * nvars * (T // freq) if freq else 0)  # state in and out, samples out
        b_ms, b_by = bound(nbytes / T, WL_OPS_PER_SPIN * spins)
        out[key] = (ms["kernel"], ms["plain"], b_ms, b_by)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            wl.wl_sweeps(s, seeds, tables, 20, freq, 20 // freq if freq else 0)
            torch.cuda.synchronize()
        dev_t = _device_times(prof, ("wl_site", "wl_cluster", "wl_accumulate"))
        if dev_t is None:
            per_launch = "per-launch device times: not measured (the profiler recorded no device time)"
        else:
            per, busy, span = dev_t
            per_launch = ("per launch " + ", ".join(f"{k} {np.mean(v):.3f} us" for k, v in sorted(per.items()))
                          + f"; device busy {busy:.1f} of {span:.1f} us over 20 sweeps, idle {100 * (1 - busy / span):.2f}%")
        print(f"timing-wl: {key} {dense[0]} n={nvars} R={R} L_tau={WL_LTAU}{' sampling freq=' + str(freq) if freq else ''}, "
              f"on {smi}: kernel {ms['kernel']:.5f} ms/sweep = {spins / (ms['kernel'] * 1e6):.3f} spin updates/ns "
              f"(runs {times['kernel']}); plain torch {ms['plain']:.5f} ms/sweep (runs {times['plain']}); "
              f"bound {b_ms:.5f} ms/sweep ({b_by}); {per_launch}", flush=True)
    return out


def pt_edges(side):
    """benches/bench_tempering.py's +-J couplings on the side x side torus."""
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges

    rng = np.random.default_rng(0)
    return [((a, b), float(rng.choice([-1.0, 1.0]))) for (a, b), _ in grid_2d_edges(side, side)]


def pt_ladder(dev, side=PT_SIDE):
    """benches/bench_tempering.py's ladder, through the user's entry point."""
    from pyisingmontecarlo_tpu_torch import LatticeTempering

    lt = LatticeTempering(pt_edges(side), seed=0, device=dev)
    for b in np.geomspace(0.2, 3.0, PT_R):
        lt.add_graph(1.0, 0.0, float(b))
    return lt


def _ladder_inputs(kind, size, jv, betas, gammas, hs, L, T, seed, dev):
    """Random worldlines constant along tau, per-sweep seeds [T, R] from a
    split key chain, and the planes."""
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
    from pyisingmontecarlo_tpu_torch.ops import ladder
    from pyisingmontecarlo_tpu_torch.rng import key_data_from_seeds, random_states
    from pyisingmontecarlo_tpu_torch.tempering import key_tables

    nvars = size if kind == "ring" else size * size
    if kind == "ring":
        ea, eb = np.arange(size), (np.arange(size) + 1) % size
    else:
        g = grid_2d_edges(size, size)
        ea, eb = np.array([a for (a, _), _ in g]), np.array([b for (_, b), _ in g])
    R = len(betas)
    kd = key_data_from_seeds(np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64))
    s = torch.from_numpy(random_states(kd, nvars)).to(dev)[:, :, None].expand(R, nvars, L).contiguous()
    seeds = torch.from_numpy(key_tables(kd, kd[0], T, 2**31 - 1)[0]).to(dev)
    planes = ladder.build_planes(kind, size, nvars, ea, eb, jv, betas, gammas, hs, L, dev)
    return s, seeds, planes


def phase_compare_ladder(dev):
    """Ladder kernel vs plain version on the card; returns the largest |difference|."""
    from pyisingmontecarlo_tpu_torch.ops import ladder

    rng = np.random.default_rng(11)
    dyadic = np.where(rng.random((4, 8)) < 0.25, 0.0, rng.choice([-1.0, -0.5, 0.5, 1.0], (4, 8)))
    glass = np.array([j for _, j in pt_edges(PT_SIDE)])
    bench = np.geomspace(0.2, 3.0, PT_R)
    cases = [  # name, kind, size, J, betas, gammas, hs, L_tau, T
        ("ring 8 R=4 h, per-replica couplings (J=0, +-0.5, +-1)", "ring", 8, dyadic, [0.8, 1.0, 1.2, 1.4],
         [1.0, 0.9, 1.0, 1.1], [0.3, 0.2, 0.0, -0.3], 40, 6),
        ("torus 12^2 +-J R=8 h=0.3", "torus", 12, glass, np.geomspace(0.2, 3.0, 8), [1.0] * 8, [0.3] * 8, 60, 4),
        ("frozen lines: ring 64 R=4 Gamma=0.05 h=0.2", "ring", 64, np.full(64, 0.7), [2.0] * 4, [0.05] * 4,
         [0.2] * 4, 40, 4),
        ("long L_tau=1200 (two-level frozen sums) ring 32 R=2", "ring", 32, np.full(32, -1.0), [60.0, 60.0],
         [0.05, 0.05], [0.1, -0.1], 1200, 3),
        (f"bench shape torus 12^2 +-J R={PT_R} L_tau={PT_LTAU}", "torus", 12, glass, bench, [1.0] * PT_R,
         [0.0] * PT_R, PT_LTAU, 4),
    ]
    worst = 0
    for k, (name, kind, size, jv, betas, gammas, hs, L, T) in enumerate(cases):
        s, seeds, planes = _ladder_inputs(kind, size, jv, betas, gammas, hs, L, T, 200 + k, dev)
        got = ladder.ladder_sweeps(s, seeds, planes, T)
        want = ladder.ladder_sweeps_reference(s, seeds, planes, T)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max().item())
        check(torch.equal(got, want), f"{name}: kernel != plain (max |diff| {err}, "
                                      f"{int((got != want).sum())} of {got.numel()} spins)")
        moved = float((got != s).float().mean())
        check(moved > 0.01, f"{name}: only {moved:.4f} of the spins moved")
        frozen = float((got == got[:, :, :1]).all(2).float().mean())
        worst = max(worst, err)
        print(f"compare-ladder: {name}, T={T}: bit-identical; {moved:.3f} of spins moved, "
              f"{frozen:.3f} of lines constant in tau", flush=True)
    return worst


def phase_main_tempering(dev):
    """The tempering path through the user's entry point at the bench ladder;
    returns the launch count."""
    from pyisingmontecarlo_tpu_torch.ops import ladder
    from pyisingmontecarlo_tpu_torch.tempering import key_tables

    lt = pt_ladder(dev)
    t0 = time.perf_counter()
    m = lt._materialize()
    setup = time.perf_counter() - t0
    check(m["L"] == PT_LTAU and m["planes"].kind == "torus", f"L_tau {m['L']}, {m['planes'].kind}")
    t0 = time.perf_counter()
    key_tables(m["key_data"], lt._swapkey, 2000, 1)
    tables = time.perf_counter() - t0
    reset_counts()
    wall, out = {}, {}
    for T in (500, 2000):
        t0 = time.perf_counter()
        out[T] = lt.qmc_timesteps_sample(T, replica_swap_freq=1)
        torch.cuda.synchronize()
        wall[T] = [time.perf_counter() - t0]
    counts = read_counts()
    want = ladder.LAUNCHES_PER_SWEEP * 2500
    check(counts == {"sq2d": 0, "wl": 0, "ladder": want}, f"launch counts {counts}, want ladder {want}")
    swaps = lt.get_total_swaps()
    for T, (states, es) in out.items():
        check(states.shape == (PT_R, T, PT_SIDE**2) and states.dtype == np.bool_, f"states {states.shape}")
        check(es.shape == (PT_R,) and es.dtype == np.float64 and np.isfinite(es).all(), f"energies {es.shape}")
    es = out[2000][1]
    check(swaps > 0, "no swap accepted")
    check(es[-8:].mean() < es[:8].mean(), f"<E> of the 8 highest betas {es[-8:].mean()} is not below "
                                          f"that of the 8 lowest {es[:8].mean()}")
    for T in (500, 2000):  # again, for the bench's min-of-two slope
        t0 = time.perf_counter()
        lt.qmc_timesteps_sample(T, replica_swap_freq=1)
        torch.cuda.synchronize()
        wall[T].append(time.perf_counter() - t0)
    dt = min(wall[2000]) - min(wall[500])
    sweeps, attempts = 1500, 1500 * (PT_R - 1) / 2
    print(f"main-tempering: LatticeTempering.qmc_timesteps_sample(500, then 2000, replica_swap_freq=1) on the "
          f"12^2 +-J glass, {PT_R} replicas, L_tau={PT_LTAU}: {counts['ladder']} launches, {swaps} accepted swaps; "
          f"host wall {wall[500][0]:.3f} s + {wall[2000][0]:.3f} s (materialize {setup:.3f} s; the seed and "
          f"uniform tables of 2000 sweeps {tables:.3f} s); slope {sweeps / dt:.2f} sweeps/s = "
          f"{attempts / dt:.1f} swap attempts/s (runs {wall}); <E> beta=0.2..0.26 {es[:8].mean():.4f}, "
          f"beta=2.3..3.0 {es[-8:].mean():.4f}", flush=True)
    return counts["ladder"], sweeps / dt, attempts / dt


def phase_physics_tempering(dev):
    from pyisingmontecarlo_tpu_torch import LatticeTempering

    ring4 = [((i, (i + 1) % 4), -1.0) for i in range(4)]
    betas = [1.0, 1.5, 2.0, 2.5]
    lt = LatticeTempering(ring4, seed=2, device=dev)
    for _ in range(6):
        for b in betas:
            lt.add_graph(1.0, 0.0, b)
    lt.qmc_timesteps(150)
    _, es = lt.qmc_timesteps_sample(250, replica_swap_freq=5)
    es = es.reshape(6, len(betas))
    out = []
    for k, b in enumerate(betas):
        exact = dense_tfim_energy(ring4, 0.0, 1.0, b, 4)
        m, se = es[:, k].mean(), es[:, k].std(ddof=1) / np.sqrt(6)
        check(abs(m - exact) < 5 * se + 0.06, f"4-ring ladder beta={b}: <E>={m} vs dense {exact} (se {se})")
        out.append(f"beta={b} <E>={m:.4f} (dense {exact:.4f}, se {se:.4f})")
    check(lt.get_total_swaps() > 0, "no swap accepted")
    print(f"physics-tempering: 4-ring ladder, 24 replicas, {lt.get_total_swaps()} swaps: " + "; ".join(out),
          flush=True)


def phase_timing_ladder(dev, smi):
    """Kernel and plain version at the bench shape (plain, kernel, kernel,
    plain, CUDA events), the device times of whole tempering steps
    (torch.profiler), and the kernel on a 64^2 +-J torus. Returns (kernel
    ms/sweep, plain ms/sweep, bound ms/sweep, bound_by)."""
    from pyisingmontecarlo_tpu_torch.ops import ladder
    from pyisingmontecarlo_tpu_torch.tempering import key_tables

    T, T_plain = 200, 3
    lt = pt_ladder(dev)
    m = lt._materialize()
    s, planes = m["s"], m["planes"]
    seeds = torch.from_numpy(key_tables(m["key_data"], lt._swapkey, T, 2**31 - 1)[0]).to(dev)
    for fn in (ladder.ladder_sweeps, ladder.ladder_sweeps_reference):  # warm-up
        fn(s, seeds[:2], planes, 2)
    k, p = in_turns(lambda: ladder.ladder_sweeps(s, seeds, planes, T),
                    lambda: ladder.ladder_sweeps_reference(s, seeds[:T_plain], planes, T_plain), T, T_plain)
    ms, plain_ms = float(np.mean(k)), float(np.mean(p))
    R, nvars = PT_R, PT_SIDE**2
    spins = R * nvars * PT_LTAU
    # the main path calls the kernel once per sweep: state in and out, seeds and parameters in
    nbytes = 2 * spins + 4 * R + 4 * R * 2 * nvars + 16 * R
    b_ms, b_by = bound(nbytes, LADDER_INT_OPS_PER_SPIN * spins, LADDER_F32_OPS_PER_SPIN * spins)
    lt.qmc_timesteps_sample(4, replica_swap_freq=1)  # warm-up
    steps = 20
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        lt.qmc_timesteps_sample(steps, replica_swap_freq=1)
        torch.cuda.synchronize()
    dev_t = _device_times(prof, ("ladder_site", "ladder_cluster"), everything=True)
    if dev_t is None:
        step = "device times of a tempering step: not measured (the profiler recorded no device time)"
    else:
        per, busy, span = dev_t
        step = (f"over {steps} tempering steps (sweep, features, swap): "
                + ", ".join(f"{n} {np.mean(v):.3f} us x {len(v)} = {np.sum(v):.1f} us"
                            for n, v in sorted(per.items()))
                + f"; device busy {busy:.1f} of {span:.1f} us, idle {100 * (1 - busy / span):.2f}%")
    big = pt_ladder(dev, side=64)
    mb = big._materialize()
    seeds_b = torch.from_numpy(key_tables(mb["key_data"], big._swapkey, 20, 2**31 - 1)[0]).to(dev)
    ladder.ladder_sweeps(mb["s"], seeds_b[:2], mb["planes"], 2)
    kb, _ = in_turns(lambda: ladder.ladder_sweeps(mb["s"], seeds_b, mb["planes"], 20), lambda: None, 20, 1)
    spins_b = R * 64 * 64 * PT_LTAU
    print(f"timing-ladder: bench shape {R} x {nvars} x {PT_LTAU} ({spins} spins), on {smi}: kernel {ms:.5f} ms/sweep "
          f"= {spins / (ms * 1e6):.3f} spin updates/ns (runs {k}); plain torch {plain_ms:.5f} ms/sweep (runs {p}); "
          f"bound {b_ms:.5f} ms/sweep ({b_by}); {step}; 64^2 +-J torus, same ladder ({spins_b} spins): kernel "
          f"{np.mean(kb):.5f} ms/sweep = {spins_b / (np.mean(kb) * 1e6):.3f} spin updates/ns (runs {kb})", flush=True)
    return ms, plain_ms, b_ms, b_by


def main():
    smi = phase_gpu()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    err = phase_compare(dev)
    launches = phase_main(dev)
    phase_physics(dev)
    ms, plain_ms = phase_timing(dev, smi)
    wl_err = phase_compare_wl(dev)
    wl_launches = phase_main_quantum(dev)
    chain_launches = phase_main_chain(dev)
    phase_physics_wl(dev)
    wl_t = phase_timing_wl(dev, smi)
    ladder_err = phase_compare_ladder(dev)
    ladder_launches, _, _ = phase_main_tempering(dev)
    phase_physics_tempering(dev)
    ladder_t = phase_timing_ladder(dev, smi)
    sites = BENCH_R * BENCH_L**2
    sq_bound, sq_by = bound(2 * sites / 1024, SQ2D_OPS_PER_SITE * sites)  # per sweep of a 1024-sweep call
    wl_src, wl_tpu = "pyisingmontecarlo_tpu_torch/csrc/wl.cu", "pyisingmontecarlo_tpu/ops/wl_pallas.py"
    kernels = [
        dict(name="sq2d_phase", route="cuda", source="pyisingmontecarlo_tpu_torch/csrc/sq2d.cu",
             replaces="pyisingmontecarlo_tpu/ops/sq2d_pallas.py:159", launches=launches, max_abs_err=err,
             ms=ms, plain_ms=plain_ms, bound_ms=sq_bound, bound_by=sq_by, library_ms=None),
        dict(name="wl_site+wl_cluster+wl_accumulate (plain sweeps)", route="cuda", source=wl_src,
             replaces=f"{wl_tpu}:330", launches=wl_launches, max_abs_err=wl_err, ms=wl_t["torus"][0],
             plain_ms=wl_t["torus"][1], bound_ms=wl_t["torus"][2], bound_by=wl_t["torus"][3], library_ms=None),
        dict(name="wl_site+wl_cluster+wl_accumulate (sampling mode)", route="cuda", source=wl_src,
             replaces=f"{wl_tpu}:346", launches=chain_launches, max_abs_err=wl_err, ms=wl_t["chain"][0],
             plain_ms=wl_t["chain"][1], bound_ms=wl_t["chain"][2], bound_by=wl_t["chain"][3], library_ms=None),
        dict(name="ladder_site+ladder_cluster", route="cuda", source="pyisingmontecarlo_tpu_torch/csrc/ladder.cu",
             replaces="pyisingmontecarlo_tpu/ops/wl_ladder_pallas.py:157", launches=ladder_launches,
             max_abs_err=ladder_err, ms=ladder_t[0], plain_ms=ladder_t[1], bound_ms=ladder_t[2],
             bound_by=ladder_t[3], library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
