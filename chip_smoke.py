#!/usr/bin/env python3
"""Drive the torch port's main path once on one NVIDIA GPU, and check it.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases, each printing one line; any failure raises and exits non-zero:

1. gpu      the card's name and power limit (nvidia-smi);
2. build    nvcc builds the CUDA kernels from ``pyisingmontecarlo_tpu_torch/csrc``;
3. compare  kernel vs its plain PyTorch version on the card, bit for bit
            (annealing, field, explicit randoms, sampling, bench shape);
4. main     ``Lattice.run_monte_carlo`` at 1024^2, 8 replicas, 1024 sweeps,
            through the kernel (launch count 2 per sweep);
5. physics  Onsager energy (L=32) and disordered magnetization (L=16);
6. timing   kernel and plain version at the bench shape, in turns.

Then one JSON line per the kernels, and last ``{"ok": true, "device": ...}``.
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
    from pyisingmontecarlo_tpu_torch.ops import lattice2d, sq2d

    T = 1024
    lat = Lattice(grid_2d_edges(BENCH_L, BENCH_L, -1.0), seed_gen=0, device=dev)
    check(lat._torus == (BENCH_L, -1.0), "the bench lattice is not detected as a torus")
    sq2d.sweeps_2d.launches = 0
    t0 = time.perf_counter()
    es, st = lat.run_monte_carlo(BENCH_BETA, T, BENCH_R)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = sq2d.sweeps_2d.launches
    check(launches == 2 * T, f"launch count {launches} != {2 * T}")
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


def phase_timing(dev, smi):
    """Kernel and plain version at the bench shape, plain-kernel-kernel-plain;
    returns (kernel ms per sweep, plain ms per sweep)."""
    from pyisingmontecarlo_tpu_torch.ops import sq2d

    T = 1024
    s, seeds = _inputs(BENCH_L, BENCH_R, 6, dev)
    thr = sq2d.thresholds(np.full(T, BENCH_BETA, np.float32), -1.0, 0.0).to(dev)
    fns = {"kernel": sq2d.sweeps_2d, "plain": sq2d.sweeps_2d_reference}
    for fn in fns.values():  # warm-up
        fn(s, seeds, thr[:8], 0)
    times = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fns[name](s, seeds, thr, 0)
        end.record()
        torch.cuda.synchronize()
        times[name].append(start.elapsed_time(end) / T)
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    flips = BENCH_R * BENCH_L**2
    print(f"timing: {BENCH_L}^2 x {BENCH_R} replicas, beta={BENCH_BETA}, {T} sweeps, on {smi}: "
          f"kernel {ms['kernel']:.5f} ms/sweep = {flips / (ms['kernel'] * 1e6):.3f} attempted flips/ns "
          f"(runs {times['kernel']}); plain torch {ms['plain']:.5f} ms/sweep = "
          f"{flips / (ms['plain'] * 1e6):.3f} flips/ns (runs {times['plain']})", flush=True)
    return ms["kernel"], ms["plain"]


def main():
    smi = phase_gpu()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    err = phase_compare(dev)
    launches = phase_main(dev)
    phase_physics(dev)
    ms, plain_ms = phase_timing(dev, smi)
    print(json.dumps({"kernels": [{
        "name": "sq2d_phase",
        "route": "cuda",
        "source": "pyisingmontecarlo_tpu_torch/csrc/sq2d.cu",
        "replaces": "pyisingmontecarlo_tpu/ops/sq2d_pallas.py:159",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
