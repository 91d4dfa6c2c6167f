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
                  each launch's device time (torch.profiler).

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
HASH_OPS = 22
SQ2D_OPS_PER_SITE = HASH_OPS + 8
WL_OPS_PER_SPIN = 2 * HASH_OPS + 18


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


def bound(nbytes, ops):
    """(least ms, what sets it) for ``nbytes`` moved and ``ops`` integer operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts():
    from pyisingmontecarlo_tpu_torch.ops import sq2d, wl

    sq2d.sweeps_2d.launches = 0
    wl.wl_sweeps.launches = 0


def read_counts():
    from pyisingmontecarlo_tpu_torch.ops import sq2d, wl

    return {"sq2d": sq2d.sweeps_2d.launches, "wl": wl.wl_sweeps.launches}


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
    check(launches == 2 * T and counts["wl"] == 0, f"launch counts {counts}, want sq2d {2 * T}")
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
    check(counts == {"sq2d": 0, "wl": wl.LAUNCHES_PER_SWEEP * T},
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
    check(counts == {"sq2d": 0, "wl": want}, f"launch counts {counts}, want wl {want}")
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


def _device_times(prof):
    """(mean us per launch by kernel, busy us, span us) of the CUDA kernels a
    torch.profiler run recorded; None when it recorded no device time."""
    evs = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name and "wl_" in e.name]
    if not evs:
        return None
    per = {}
    for e in evs:
        name = next(k for k in ("wl_site", "wl_cluster", "wl_accumulate", e.name) if k in e.name)
        per.setdefault(name, []).append(e.time_range.elapsed_us())
    busy = sum(sum(v) for v in per.values())
    span = max(e.time_range.end for e in evs) - min(e.time_range.start for e in evs)
    return {k: float(np.mean(v)) for k, v in per.items()}, busy, span


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
        dev_t = _device_times(prof)
        if dev_t is None:
            per_launch = "per-launch device times: not measured (the profiler recorded no device time)"
        else:
            per, busy, span = dev_t
            per_launch = ("per launch " + ", ".join(f"{k} {v:.3f} us" for k, v in sorted(per.items()))
                          + f"; device busy {busy:.1f} of {span:.1f} us over 20 sweeps, idle {100 * (1 - busy / span):.2f}%")
        print(f"timing-wl: {key} {dense[0]} n={nvars} R={R} L_tau={WL_LTAU}{' sampling freq=' + str(freq) if freq else ''}, "
              f"on {smi}: kernel {ms['kernel']:.5f} ms/sweep = {spins / (ms['kernel'] * 1e6):.3f} spin updates/ns "
              f"(runs {times['kernel']}); plain torch {ms['plain']:.5f} ms/sweep (runs {times['plain']}); "
              f"bound {b_ms:.5f} ms/sweep ({b_by}); {per_launch}", flush=True)
    return out


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
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
