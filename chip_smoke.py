#!/usr/bin/env python3
"""Drive the torch port's main paths once on one NVIDIA GPU, and check them.

    python3 chip_smoke.py        # from the root of a checkout, on a machine with a card

Phases, each printing at least one line; any failure raises and exits non-zero:

1.  gpu           the card's name and power limit (nvidia-smi);
2.  build         nvcc builds the CUDA kernels from ``pyisingmontecarlo_tpu_torch/csrc``
                  and prints the registers, shared memory and spills of each;
3.  compare       the square-torus kernel (``sq2d_tiled``) vs its plain
                  PyTorch version on the card, bit for bit (annealing, field,
                  explicit randoms, sampling, bench shape; L = 6, 16 and 200,
                  37 sweeps across launch boundaries from ctr0 = 3, sampling
                  every 3 sweeps and every sweep, explicit randoms over
                  several launches, draws and thresholds over the whole
                  int32 range), and every (B, K) of a grid against the plan's
                  at the bench shape;
4.  main          ``Lattice.run_monte_carlo`` at 1024^2, 8 replicas, 1024
                  sweeps, through the kernel (``sq2d_plan``'s ceil(T / K)
                  launches);
5.  physics       Onsager energy (L=32) and disordered magnetization (L=16);
6.  compare-wl    the worldline kernels vs their plain version, bit for bit:
                  the multi-launch, resident and tiled kernels (the gate's
                  route through the wrapper, the others through their private
                  launchers where the shape fits them), each against the plain
                  version and the multi-launch kernels (ring, torus with
                  field, frozen rings, long L_tau, sampling, L_tau=4, the
                  longest chain the gate admits, R=1, odd R, tori 24^2 to
                  100^2, a side that is not a multiple of the tile, an 8192
                  ring, the 256^2 x 8 x 40 main shape in plain and sampling
                  mode, and a 64^2 torus at L_tau=800 that no tile fits); the
                  multi-launch kernels at L_tau = 700, 800, 1002 and 4096 on
                  rings and tori, plain and sampling mode, with lines frozen
                  whole at high K_tau (each of the three cluster group sizes);
                  at L_tau = 62 and 66 (2-byte words) on a 30-ring and a 14^2
                  torus, R = 3, sampling every 2 and 3 of 5 and 7 sweeps;
                  at L_tau = 130 and 514 (wl_site's 16 threads a line, and
                  a warp's two chunks, the last of one pair);
7.  main-quantum  ``Lattice.run_quantum_monte_carlo(2.0, 200, 8)`` on the
                  256^2 TFIM torus (the shape of benches/bench_qmc_large.py;
                  tiled, one launch per sweep);
8.  main-quantum-sampling  ``run_quantum_monte_carlo_sampling`` on the same
                  torus, 20 sweeps (the tiled kernel's sampling mode);
9.  main-quantum-long  both entry points on a 64^2 torus at beta=40, so
                  L_tau=800, 5 and 4 sweeps (multi-launch, 5 launches per
                  sweep: 2 wl_site, both tau parities of a color each, 2
                  wl_cluster, 1 wl_accumulate; plain and sampling mode);
10. main-chain    ``Lattice.run_quantum_monte_carlo_sampling`` on the 256-site
                  TFIM chain, 64 replicas, 500 + 2000 sweeps (benches/bench_qmc.py's
                  shape; resident, one launch per call), against the exact
                  free-fermion energy;
11. physics-wl    <E> of a 6-ring against dense diagonalization, and a bond
                  autocorrelation on a 32^2 torus;
12. compare-ladder    the ladder kernels vs their plain version, bit for bit
                  in states and swap features: resident and multi-launch,
                  each against the plain version and each other (ring with
                  field and per-replica couplings, 12^2 +-J torus, frozen
                  lines, L_tau=1200, L_tau=4 with R=1, odd R, a 24^2 torus,
                  a 48^2 torus off the gate, the 64 x 144 x 60 bench shape,
                  the 64 x 4096 x 60 shape of main-tempering-wide, and the
                  glass80.pt cell's 64 x 6400 x 60, whose features are taken
                  again by a launch at T = 0); the multi-launch kernels at
                  L_tau = 700, 800, 974, 3906 and 4096 on rings and +-J tori,
                  with lines frozen whole at high K_tau, at L_tau = 62 and 66
                  on a 30-ring and a 14^2 +-J torus, R = 3, and at L_tau = 130
                  and 514 (ladder_site's 16 threads a line, and a warp's two
                  chunks, the last of one pair);
13. main-tempering    ``LatticeTempering.qmc_timesteps_sample`` at t = 500, then
                  2000, on the ladder of benches/bench_tempering.py (12^2 +-J
                  spin glass, 64 replicas, L_tau = 60; resident, one launch per
                  sweep, features from the kernel), with sweeps/s and swap
                  attempts/s as that bench takes them;
14. main-tempering-wide  the same ladder on a 64^2 +-J torus, 5 sweeps
                  (multi-launch, 4 launches per sweep: 2 ladder_site, 2
                  ladder_cluster);
15. physics-tempering per-rung <E> of a 4-ring ladder against dense diagonalization;
16. compare-longline  the multi-launch kernels vs their plain version past
                  L_tau = 4096, bit for bit, through the wrappers (launch
                  counts checked): the worldline kernels in plain and sampling
                  mode at L_tau = 4098, 5120, 10,240, the longest line one
                  block holds (26,944 on an H100), one pair past it, 40,960
                  and 2^20 (the 4-ring at the gate's edge), and lines frozen
                  whole at 40,960 and 2^20; the ladder kernels (states and
                  swap features) on the 12^2 +-J glass at 5120, the 16-ring at
                  40,960 (also frozen whole) and the 4-ring at 250,000 (the
                  gate's edge); past one block the cluster phase is fk_long_*
                  (fk_long_sums and fk_long_apply, two launches a color);
17. compare-replicas  the kernels at replica counts past one launch's limits
                  (ops/replicas.py), each call in chunks of replicas, launch
                  counts checked, the replicas on each side of every chunk
                  boundary (and the first and last) bit for bit a call of
                  them alone on the kernel and the plain version: sq2d_tiled
                  at bench.py's 1024^2 lattice, R = 2048 (2^31 spins), and a
                  32^2 torus at R = 65,600 (sampling, explicit randoms); the
                  worldline multi-launch kernels on a 64^2 torus at L_tau =
                  800, R = 656 (2.15e9 spins), the 4-ring at L_tau = 2^20, R
                  = 512 (fk_long_*, two chunks) and at 4100, R =
                  65,600 (sampling); the ladder's on the 4-ring at 4100, R =
                  65,600 and the 12^2 +-J glass at 5120, R = 2913; then
                  LatticeTempering on that glass ladder (2 sweeps with swaps)
                  and QmcIsing on the 64^2 torus at R = 656, both on the
                  kernels;
18. main-quantum-longline  ``Lattice.run_quantum_monte_carlo(512, 300, 64)`` and
                  ``run_quantum_monte_carlo_sampling(512, 300, 64, wait 300,
                  freq 10)`` on the 128-ring TFIM at its critical point
                  (L_tau = 10,240; multi-launch, the cluster phase a block of
                  512 threads a line) against the exact free-fermion energy
                  (chain_energy, in logs), launches by kernel, other device
                  operations and the idle share of a profiled 20-sweep call;
                  both entry points on the 16-ring at beta = 2048 (L_tau =
                  40,960: 3 wl launches and 4 fk_long_* launches a sweep);
19. main-tempering-longline  ``LatticeTempering.qmc_timesteps_sample(200)`` on
                  the tempering bench's 12^2 +-J glass with 64 rungs at
                  geomspace(0.2, 256) (L_tau = 5120; multi-launch), swaps
                  accepted and <E> falling with beta, a profiled 10-sweep
                  call; a 4-ring ladder at beta up to 12,500 (L_tau = 250,000:
                  2 ladder_site and 4 fk_long_* launches a sweep);
20. compare-keychain  the key chain's kernel (``threefry_chain``, csrc/keychain.cu)
                  vs its numpy version, bit for bit: the main path's plan (200
                  steps x 29 slots x R = 100), a plan with worm and cluster
                  slots at R = 1 over 2^16 chained splits and a plan of every
                  slot kind (fan and bits of m = 0 among them) at R = 100;
21. compare-key-tables  LatticeTempering's key tables on the card
                  (tempering.key_tables_device: a plain slot a sweep, a
                  uniform slot a swap step) vs the numpy key_tables, bit for
                  bit, at glass80.pt's 64 rungs x 500 sweeps, 33 rungs and
                  16 rungs; key_tables_device.launches over two
                  ladder calls;
22. compare-classical the graph engine on the card vs on the CPU, bit for bit, in
                  every family (spin on the dense int, dense hi+lo and ELL
                  paths, edge with and without importance weights, worms, SW
                  with a field, annealing energies) at small shapes; then one
                  default step of the main path at full width, move by move,
                  where every differing spin must be an f32 tie;
23. main-classical    ``Lattice.run_monte_carlo_annealing_and_get_energies`` of
                  BASELINE.json config 2 (benches/bench_configs.py: the 48^2
                  triangular AFM, 100 experiments, beta 0.1 -> 3.0), depth
                  cut from 4000 steps to 200: one threefry_chain launch, steps/s
                  and site-steps/s, the graph's set-up, torch and device
                  operations a step and the idle share (torch.profiler over a
                  20-step call); the last energy column against ``energy`` of
                  the states, <E> falling along the schedule;
24. main-classicising ``ClassicIsing`` on benches/bench_classical_graph.py's 4-regular
                  +-J glass (R = 64, beta = 1.5): ms a step of each move family
                  at n = 4096 (dense) and of the spin family at n = 16384
                  (ELL); ``get_energies`` against the run's energies;
25. physics-classical <E> of a frustrated 10-site graph with a field against exact
                  enumeration (Lattice with and without clusters, ClassicIsing);
26. compare-qmc-generic the generic worldline engine on the card vs on the CPU,
                  bit for bit in states, keys, samples, cluster sizes and RVB
                  ratios (run_sweeps, run_sweeps_sample, run_diagonal_sweeps,
                  run_single_cluster, run_rvb_sweeps; a 64-site glass and a
                  6 x 6 triangular patch, RVB on), energies within 2e-6
                  relative; one sweep of the main path's glass at full width,
                  phase by phase, where every differing spin must be an f32
                  tie; threefry_chain with the main path's all-plain plan vs
                  its numpy version, bit for bit;
27. main-qmcising ``QmcIsing`` on the 4-regular +-J glass of
                  benches/bench_classical_graph.py (n = 4096, R = 64, Gamma = 1,
                  beta = 2, L_tau = 40): run_qmc(2.0, 100), then
                  run_sampling(2.0, 200, sampling_freq=10) (generic route, one
                  threefry_chain launch a call): sweeps/s, spin updates/ns,
                  torch and device operations a sweep and the idle share
                  (torch.profiler over a 20-sweep call);
28. main-qmcising-lattice ``QmcIsing`` on the 256^2 torus (R = 8, 200 sweeps;
                  wl_tiled) and run_sampling on the 256-chain (R = 64;
                  wl_resident), against the exact free-fermion energy;
29. physics-qmcising <E> against dense diagonalization: QmcIsing on an 8-site
                  +-J graph with a field and RVB, Lattice on a 3 x 3 triangular
                  patch with RVB, each rung of a LatticeTempering glass ladder
                  off the ladder kernel's gate; cluster sizes and RVB ratios in
                  range;
30. compare-qmcrunner the generic k-local engine on the card vs on the CPU:
                  QmcRunner on a 5-ring with ZZ, X, XX and ZZZ terms and a free
                  variable, both routes forced, with and without do_loop, bit
                  for bit (states, samples, bond counts, keys); the hard family
                  at n = 128 takes each route forced; one gm sweep of the hard
                  n = 32, R = 64 system at full width with its Glauber ties
                  counted (the card replays the CPU's decisions);
                  threefry_chain's fan, slice and bits slots vs its numpy
                  version bit for bit (a plan of every kind, the do_loop plan,
                  the hard plan at 100 sweeps x R = 64);
31. main-qmcrunner    QmcRunner.run_sampling as benches/bench_qmcrunner_hard.py
                  and bench_qmcrunner.py time it, depth cut to a quarter: the
                  hard n = 32 system (ZZ, X, XX, ZZZ on a ring; R = 64, beta 1;
                  slope between 50 and 200 sweeps) and the 64-site TFIM chain
                  (slope between 100 and 400): sweeps/s, site-subslice updates/s, the route, set-up
                  seconds, torch and device operations a sweep, device ms a
                  sweep and the idle share (torch.profiler over 20 sweeps), one
                  threefry_chain launch a call; the chain against the exact
                  free-fermion energy;
32. physics-qmcrunner <E> against dense diagonalization: a 6-ring with XX bonds
                  and an 8-ring with ZZZ triples, 256 replicas;
33. compare-threefry-bits the threefry bits kernel (``threefry_bits``,
                  csrc/keychain.cu) vs rng.random_bits / uniform_f32 (numpy), bit
                  for bit in both modes: one key over 1 M and 8 M counters, 64
                  keys, an odd size;
34. compare-parallel the multi-device paths on a one-rank NCCL group on the card:
                  QmcRunner (both routes), QmcIsing and the tempering ladder,
                  replica-sharded, each bit for bit its unsharded run on the card,
                  with both host walls; the spatial and tau-sharded sweeps bit for
                  bit the same sweeps on the CPU;
35. main-parallel the sharded ladder at benches/bench_tempering.py's shape
                  (qmc_timesteps_sample(500, replica_swap_freq=1): 500
                  ladder_resident launches), the spatial sweep at bench.py's
                  1024^2 x 8 (20 sweeps) and the tau sweep at
                  examples/tau_sharded_tfim.py's 16-ring (L_tau = 64, 128
                  replicas, 100 sweeps against the exact free-fermion energy),
                  each one threefry_bits launch a phase; sweeps/s beside the
                  unsharded route's;
36. graph-native  the native graph library (``_native_graph``, g++ at first use)
                  built on this host from the checkout, each of its four passes
                  array for array the python pass's on benches/bench_classical_graph.py's
                  4-regular +-J glass at n = 4096 and 16384 and on BASELINE.json
                  config 2's 48^2 triangular lattice, the set-up ms both ways;
                  ClassicIsing on the n = 16384 glass takes the native build;
37. shim          the reference README's first example, verbatim, through
                  ``py_monte_carlo_torch`` on the default device (the card);
38. examples      each twin of examples/ (pyisingmontecarlo_tpu_torch/examples/)
                  through its ``main([])`` on the card, the ferromagnet also at
                  L = 256: its wall, its launches (each twin must launch its
                  path's kernel) and its physics (Onsager, the free-fermion
                  energy, accepted swaps, the Richardson estimate).

Every profiled call's launches are checked against the wrapper's count:
``_launches`` takes up to three traces (``_trace``: a profiler schedule's
warm-up step, then the recorded call) until one records as many launches as
the wrapper counts, and fails if any records more (the profiler can drop
records; it never adds them). The kernels' times and bounds are the
benchmark's (``portbench/``), not this script's.

Then one JSON line with the kernels (each one's launches, summed over the
main paths that launched it, and its largest difference from its plain
version), and last ``{"ok": true, "device": ...}``. Needs torch with CUDA,
nvcc and numpy; imports no jax.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
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
# the multi-launch kernels' main path: a 64^2 torus at beta=40, Gamma=1, so L_tau = 800, too long for a
# tile of 8 sites and its halo in shared memory (ops/wl.tiled_plan)
LONG_BETA, LONG_LTAU = 40.0, 800
LONG = (("torus", 64, -1.0), 64 * 64, 2)
# the tempering ladder of benches/bench_tempering.py (the BASELINE.json
# "Parallel tempering" config): 12^2 periodic +-J spin glass, 64 replicas at
# geomspace(0.2, 3.0), Gamma = 1, h = 0, so L_tau = 60
PT_SIDE, PT_R, PT_LTAU = 12, 64, 60
GLASS80_SIDE = 80  # the glass80.pt cell's torus (portbench/configs/pmj_glass_80_pt64.json) on the ladder above
# the long time lines: the 128-ring TFIM at its critical point (J = -1, Gamma = 1) at beta = 4 N = 512,
# dtau 0.05, so L_tau = 10,240, 64 replicas (finite-size scaling of the ground state takes beta of order N); the
# tempering ladder above with its rungs at geomspace(0.2, 256, 64), so L_tau = 5120 (low-temperature tempering);
# and the lines past one block's shared memory through the entry points: the 16-ring at beta = 2048 (L_tau =
# 40,960), R = 2, and a 4-ring ladder with rungs up to beta = 12,500 (L_tau = 250,000)
LL = (("ring", 128, -1.0), 128, 64)
LL_BETA, LL_LTAU = 512.0, 10240
LLPT_BETA, LLPT_LTAU = 256.0, 5120


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


def reset_counts():
    from pyisingmontecarlo_tpu_torch import rng
    from pyisingmontecarlo_tpu_torch.ops import ladder, sq2d, wl

    rng.threefry_chain.launches = 0
    rng.threefry_bits.launches = 0
    sq2d.sweeps_2d.launches = 0
    wl.wl_sweeps.launches = 0
    wl.wl_sweeps.long_launches = 0
    wl.wl_sweeps.resident_launches = 0
    wl.wl_sweeps.tiled_launches = 0
    ladder.ladder_sweeps.launches = 0
    ladder.ladder_sweeps.long_launches = 0
    ladder.ladder_sweeps.resident_launches = 0


def read_counts():
    from pyisingmontecarlo_tpu_torch import rng
    from pyisingmontecarlo_tpu_torch.ops import ladder, sq2d, wl

    return {"keychain": rng.threefry_chain.launches, "bits": rng.threefry_bits.launches,
            "sq2d": sq2d.sweeps_2d.launches, "wl": wl.wl_sweeps.launches, "wl_long": wl.wl_sweeps.long_launches,
            "wl_resident": wl.wl_sweeps.resident_launches, "wl_tiled": wl.wl_sweeps.tiled_launches,
            "ladder": ladder.ladder_sweeps.launches, "ladder_long": ladder.ladder_sweeps.long_launches,
            "ladder_resident": ladder.ladder_sweeps.resident_launches}


def counts_only(**want):
    """The launch counts with ``want`` and zeros elsewhere."""
    return {**dict.fromkeys(("keychain", "bits", "sq2d", "wl", "wl_long", "wl_resident", "wl_tiled", "ladder",
                             "ladder_long", "ladder_resident"), 0),
            **want}


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
    """The kernels, verbose: nvcc prints the registers, shared memory and spills of each."""
    from pyisingmontecarlo_tpu_torch import _kernels

    t0 = time.perf_counter()
    path = _kernels.build(verbose=True)
    _kernels.load()
    print(f"build: {time.perf_counter() - t0:.3f} s, {path.relative_to(HERE)}", flush=True)


def _inputs(L, R, seed, dev):
    from pyisingmontecarlo_tpu_torch.ops.lattice2d import random_states_2d
    from pyisingmontecarlo_tpu_torch.rng import replica_seeds_i32

    u64 = np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64)
    seeds = torch.from_numpy(replica_seeds_i32(u64)).to(dev)
    return random_states_2d(seeds, L), seeds


# the (B, K) grid that compare holds to the plan's result at the bench shape
SQ2D_GRID_B, SQ2D_GRID_K = (64, 128, 192, 256), (2, 4, 8, 16)


def phase_compare(dev):
    """Kernel vs plain version on the card, through the wrapper (the plan's
    (B, K)); then every (B, K) of a grid against the plan's result
    at the bench shape; returns the largest |difference|."""
    from pyisingmontecarlo_tpu_torch._kernels import device_limits
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
    # lattices smaller than the box and not a multiple of the tile, 37 sweeps across launch boundaries
    # from ctr0 = 3 under an annealing schedule, sampling every 3 sweeps and every sweep, explicit
    # randoms over several launches
    for L, R in ((6, 3), (16, 2), (200, 2)):
        s, seeds = _inputs(L, R, 10 + L, dev)
        cases.append((f"anneal L={L} R={R} T=37 ctr0=3", s, seeds, sq2d.thresholds(sched, -1.0, 0.1), 3, {}))
    s, seeds = _inputs(200, 2, 20, dev)
    cases.append(("sampling L=200 R=2 freq=3 T=37 ctr0=3", s, seeds, sq2d.thresholds(sched, -1.0, 0.0), 3,
                  dict(samples=3)))
    s, seeds = _inputs(64, 3, 21, dev)
    cases.append(("sampling L=64 R=3 freq=1 T=20", s, seeds,
                  sq2d.thresholds(np.full(20, 0.44, np.float32), -1.0, 0.0), 7, dict(samples=1)))
    s, seeds = _inputs(64, 2, 22, dev)
    rb = torch.from_numpy(rng.integers(0, 2**31, (2 * 37, 64, 32), dtype=np.int64).astype(np.int32)).to(dev)
    cases.append(("explicit rb L=64 R=2 T=37 (several launches)", s, seeds, sq2d.thresholds(sched, 0.7, 0.0), 0,
                  dict(rb=rb)))
    # thresholds, and draws from random planes, over the whole int32 range, the ends and their neighbours
    # among them: the kernel's flip test u <= t is exact for every pair
    ends = np.array([-2**31, -2**31 + 1, -2, -1, 0, 1, 2**31 - 2, 2**31 - 1], np.int64)

    def full_range(shape):
        v = rng.integers(-2**31, 2**31, int(np.prod(shape)), dtype=np.int64)
        pick = rng.random(v.size) < 0.25
        v[pick] = rng.choice(ends, int(pick.sum()))
        return torch.from_numpy(v.reshape(shape).astype(np.int32))

    s, seeds = _inputs(64, 2, 24, dev)
    cases.append(("full-range thresholds L=64 R=2 T=9, hashed draws", s, seeds, full_range((9, 10)), 0, {}))
    cases.append(("full-range thresholds and explicit rb L=64 R=2 T=9", s, seeds, full_range((9, 10)), 0,
                  dict(rb=full_range((18, 64, 32)).to(dev))))
    lim = device_limits(dev)
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
        B, K = sq2d.sq2d_plan(s.shape[1], s.shape[0], *lim, "rb" in kw)[:2]
        print(f"compare: {name}: bit-identical ({sum(g.numel() for g in got)} spins; B={B} K={K}, "
              f"{-(-thr.shape[0] // K)} launches)", flush=True)
    # every (B, K) of the grid against the plan's result
    s, seeds = _inputs(BENCH_L, BENCH_R, 23, dev)
    thr = sq2d.thresholds(sched, -1.0, 0.0).to(dev)
    want = sq2d.sweeps_2d(s, seeds, thr, 3, samples=5)
    runs = {f"B={B} K={K}": (lambda B=B, K=K: sq2d._run_tiled(s, seeds, thr, 3, None, 5, (B, K)))
            for B in SQ2D_GRID_B for K in SQ2D_GRID_K}
    for name, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)), f"bench shape {name}: != the plan's result")
    print(f"compare: bench L={BENCH_L} R={BENCH_R} T=37 ctr0=3 sampling freq=5: {', '.join(runs)} bit-identical "
          f"to the plan's {sq2d.sq2d_plan(BENCH_L, BENCH_R, *lim)[:2]}", flush=True)
    return worst


def phase_main(dev):
    """The main path through the user's entry point; returns the launch count."""
    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
    from pyisingmontecarlo_tpu_torch.ops import lattice2d
    from pyisingmontecarlo_tpu_torch.ops.sq2d import sq2d_plan
    from pyisingmontecarlo_tpu_torch._kernels import device_limits

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
    plan = sq2d_plan(BENCH_L, BENCH_R, *device_limits(dev))
    want = -(-T // plan[1])
    check(launches < T and counts == counts_only(sq2d=want), f"launch counts {counts}, want sq2d {want} only")
    check(es.shape == (BENCH_R,) and es.dtype == np.float64, f"energies {es.shape} {es.dtype}")
    check(st.shape == (BENCH_R, BENCH_L * BENCH_L) and st.dtype == np.bool_, f"states {st.shape} {st.dtype}")
    check(np.isfinite(es).all(), "non-finite energies")
    s = torch.from_numpy(np.where(st, 1, -1).astype(np.int8).reshape(BENCH_R, BENCH_L, BENCH_L)).to(dev)
    again = lattice2d.energy_2d(s, -1.0, 0.0).cpu().numpy().astype(np.float64)
    check(np.array_equal(es, again), "energies != energy_2d(states)")
    u = es.mean() / BENCH_L**2
    check(abs(u - onsager_u(BENCH_BETA)) < 0.01, f"u={u} vs Onsager {onsager_u(BENCH_BETA)}")
    print(f"main: Lattice.run_monte_carlo({BENCH_BETA}, {T}, {BENCH_R}) at {BENCH_L}^2: "
          f"{launches} launches (B={plan[0]}, K={plan[1]}), {dt:.3f} s host wall, u={u:.6f} (Onsager {onsager_u(BENCH_BETA):.6f})", flush=True)
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


def cluster_group(L):
    """The threads a time line of the multi-launch cluster phases at L_tau =
    ``L`` (csrc/worldline.cuh, fk_group)."""
    from pyisingmontecarlo_tpu_torch import _kernels

    return _kernels.load().pmc_cluster_group(L)


def _wl_inputs(dense, nvars, R, seed, dev, ltau=WL_LTAU):
    """Random worldlines constant along tau (as a fresh run starts) and seeds."""
    from pyisingmontecarlo_tpu_torch.rng import key_data_from_seeds, random_states, seeds_from_key_data

    u64 = np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64)
    kd = key_data_from_seeds(u64)
    s = torch.from_numpy(random_states(kd, nvars)).to(dev)[:, :, None].expand(R, nvars, ltau).contiguous()
    return s, torch.from_numpy(seeds_from_key_data(kd)).to(dev)


def _equal_all(got, want):
    """(all equal, largest |difference|) over matching tensors."""
    err = max((int((g.to(torch.int64) - w.to(torch.int64)).abs().max().item()) if g.numel() else 0)
              for g, w in zip(got, want))
    return all(torch.equal(g.to(torch.int64), w.to(torch.int64)) for g, w in zip(got, want)), err


def phase_compare_wl(dev):
    """Worldline kernels vs the plain version on the card: the multi-launch
    kernels, the resident kernel and the tiled kernel (each through the
    wrapper where the gate picks it, else through its private launcher where
    the shape fits it), each against the plain version and against the
    multi-launch kernels; returns {route: largest |difference|}."""
    from pyisingmontecarlo_tpu_torch._kernels import device_limits
    from pyisingmontecarlo_tpu_torch.ops import wl

    lim = device_limits(dev)
    longest = max(L for L in range(4, wl.MAX_LTAU + 1, 2) if wl.resident_plan(256, L, 1, wl.WL_PARAM_BYTES, *lim))
    cases = [  # name, dense, nvars, R, L_tau, T, beta, gamma, h, freq, nsamples
        ("ring 256 R=4 L=40 T=13", ("ring", 256, -1.0), 256, 4, 40, 13, 2.0, 1.0, 0.0, 0, 0),
        ("torus 16^2 R=2 h=-0.3 T=9", ("torus", 16, -1.0), 256, 2, 40, 9, 2.0, 1.0, -0.3, 0, 0),
        ("frozen rings: ring 64 R=4 Gamma=0.05 h=0.2 T=9", ("ring", 64, 0.7), 64, 4, 40, 9, 2.0, 0.05, 0.2, 0, 0),
        ("long L_tau=1200 (two-level frozen sums) ring 32 R=2 T=5", ("ring", 32, -1.0), 32, 2, 1200, 5,
         60.0, 0.05, 0.1, 0, 0),
        ("sampling chain 256 R=64 freq=3 nsamples=4 rem=2", CHAIN[0], 256, 64, 40, 14, 2.0, 1.0, 0.0, 3, 4),
        ("L_tau=4 ring 8 R=3 sampling freq=2 nsamples=3 T=7", ("ring", 8, -1.0), 8, 3, 4, 7, 0.4, 1.0, 0.1, 2, 3),
        (f"longest chain the gate admits: L_tau={longest} R=1 T=3", CHAIN[0], 256, 1, longest, 3,
         WL_BETA * longest / WL_LTAU, 1.0, 0.0, 0, 0),
        ("torus 24^2 R=5 L=40 T=6", ("torus", 24, -1.0), 576, 5, 40, 6, 2.0, 1.0, 0.2, 0, 0),
        ("torus 32^2 R=3 L=40 T=4", ("torus", 32, -1.0), 1024, 3, 40, 4, 2.0, 1.0, 0.0, 0, 0),
        ("torus 48^2 R=2 L=40 T=3 (fits resident; the gate leaves it to the tiled kernel)", ("torus", 48, -1.0),
         2304, 2, 40, 3, 2.0, 1.0, 0.0, 0, 0),
        ("main torus 256^2 R=8 L=40 T=4", TORUS[0], TORUS[1], TORUS[2], 40, 4, WL_BETA, WL_GAMMA, 0.0, 0, 0),
        ("main torus 256^2 R=8 L=40 sampling freq=2 nsamples=2 T=4", TORUS[0], TORUS[1], TORUS[2], 40, 4,
         WL_BETA, WL_GAMMA, 0.0, 2, 2),
        ("torus 100^2 R=5 L=40 h=0.1 T=3 (the side not a multiple of the tile)", ("torus", 100, -1.0), 10000, 5,
         40, 3, 2.0, 1.0, 0.1, 0, 0),
        ("ring 8192 R=3 L=40 T=4 (too long for the resident kernel)", ("ring", 8192, -1.0), 8192, 3, 40, 4,
         2.0, 1.0, 0.0, 0, 0),
        ("frozen lines, tiled: ring 4096 R=2 Gamma=0.05 h=0.2 sampling freq=1 nsamples=3 T=4", ("ring", 4096, 0.7),
         4096, 2, 40, 4, 2.0, 0.05, 0.2, 1, 3),
        ("odd R: torus 64^2 R=3 L=40 T=3", ("torus", 64, -1.0), 4096, 3, 40, 3, 2.0, 1.0, -0.2, 0, 0),
        ("R=1: torus 64^2 L=60 T=3", ("torus", 64, -1.0), 4096, 1, 60, 3, 3.0, 1.0, 0.0, 0, 0),
        ("L_tau=30 (lines not padded) torus 40^2 R=16 T=3", ("torus", 40, -1.0), 1600, 16, 30, 3, 1.5, 1.0, 0.0, 0,
         0),
        ("L_tau=200 (13 counter levels) torus 64^2 R=2 T=2", ("torus", 64, -1.0), 4096, 2, 200, 2, 10.0, 1.0, 0.0,
         0, 0),
        (f"long L_tau: torus 64^2 R=2 L={LONG_LTAU} T=2 (no tile fits: multi-launch)", LONG[0], LONG[1], LONG[2],
         LONG_LTAU, 2, LONG_BETA, WL_GAMMA, 0.0, 0, 0),
        (f"long L_tau sampling: torus 64^2 R=2 L={LONG_LTAU} freq=2 nsamples=2 T=4 (main-quantum-long's sampling "
         "mode, multi-launch)", LONG[0], LONG[1], LONG[2], LONG_LTAU, 4, LONG_BETA, WL_GAMMA, 0.0, 2, 2),
    ]
    # the multi-launch route's lengths, each cluster group size fk_group picks: L_tau = 700, 800, 1002 (not a
    # multiple of 32) and 4096, rings and tori, plain and sampling mode; dtau * Gamma = 0.001 or less freezes
    # lines whole (L_tau = 4096: two levels of XLA's windows)
    cases += [
        ("multi-launch L=700: torus 64^2 R=2 T=2", LONG[0], LONG[1], 2, 700, 2, 35.0, 1.0, 0.0, 0, 0),
        ("multi-launch L=800 sampling: ring 512 R=3 freq=1 nsamples=2 T=2", ("ring", 512, -1.0), 512, 3, 800, 2,
         40.0, 1.0, 0.1, 1, 2),
        ("multi-launch L=1002: ring 256 R=2 h=-0.2 T=3", ("ring", 256, -1.0), 256, 2, 1002, 3, 50.1, 1.0, -0.2, 0,
         0),
        ("multi-launch L=1002 sampling: torus 32^2 R=2 freq=2 nsamples=1 T=3", ("torus", 32, -1.0), 1024, 2, 1002,
         3, 50.1, 1.0, 0.0, 2, 1),
        ("multi-launch L=4096: torus 16^2 R=2 T=2", ("torus", 16, -1.0), 256, 2, 4096, 2, 204.8, 1.0, 0.0, 0, 0),
        ("multi-launch L=4096 sampling: ring 64 R=2 freq=1 nsamples=2 T=2", ("ring", 64, -1.0), 64, 2, 4096, 2,
         204.8, 1.0, 0.1, 1, 2),
        ("multi-launch L=800, high K_tau (lines frozen whole): ring 64 R=4 Gamma=0.02 h=0.2 T=3", ("ring", 64, 0.7),
         64, 4, 800, 3, 40.0, 0.02, 0.2, 0, 0),
        ("multi-launch L=4096, high K_tau: torus 16^2 R=2 Gamma=0.02 sampling freq=1 nsamples=2 T=2",
         ("torus", 16, -1.0), 256, 2, 4096, 2, 40.0, 0.02, 0.1, 1, 2),
    ]
    # where wl_accumulate's indexing could go wrong: L_tau = 2 mod 4 (2-byte words), a row of lines that is not a
    # multiple of the 8 a block holds (30 on the ring, 14 on the torus), odd R, samples every freq sweeps with
    # freq not dividing T
    cases += [
        ("multi-launch L=62 (2 mod 4): ring 30 R=3 h=0.1 sampling freq=2 nsamples=2 T=5", ("ring", 30, -1.0), 30, 3,
         62, 5, 3.1, 1.0, 0.1, 2, 2),
        ("multi-launch L=66 (2 mod 4): torus 14^2 R=3 sampling freq=3 nsamples=2 T=7", ("torus", 14, -1.0), 196, 3,
         66, 7, 3.3, 1.0, 0.0, 3, 2),
    ]
    # wl_site's other thread counts and chunks: 16 threads a line (L_tau = 130), a warp's two chunks, the last of
    # one pair (L_tau = 514), both in 2-byte words
    cases += [
        ("multi-launch L=130 (16 threads a line): torus 14^2 R=3 h=0.1 T=3", ("torus", 14, -1.0), 196, 3, 130, 3,
         6.5, 1.0, 0.1, 0, 0),
        ("multi-launch L=514 (a last chunk of one pair): ring 30 R=3 sampling freq=1 nsamples=2 T=2",
         ("ring", 30, -1.0), 30, 3, 514, 2, 25.7, 1.0, 0.0, 1, 2),
    ]
    worst = {"multi": 0, "resident": 0, "tiled": 0}
    for k, (name, dense, nvars, R, L, T, beta, gamma, h, freq, ns) in enumerate(cases):
        s, seeds = _wl_inputs(dense, nvars, R, 100 + k, dev, L)
        tables = wl.make_tables(dense, nvars, beta, gamma, h, L, dev)
        route, _ = wl.choose_route(dense[0], dense[1], nvars, L, R, *lim)
        fit = wl.resident_plan(nvars, L, R, wl.WL_PARAM_BYTES, *lim, None)  # the idle-sites threshold lifted
        tiles = wl.tiled_plan(dense[0], dense[1], nvars, L, R, *lim)
        want = wl.wl_sweeps_reference(s, seeds, tables, T, freq, ns)
        runs = {"multi": wl._run_multi(s, seeds, tables, T, freq, ns)}
        how = {"multi": f"{'gate' if route == 'multi' else 'private launcher'}, group {cluster_group(L)}"}
        if fit:
            runs["resident"] = (wl.wl_sweeps(s, seeds, tables, T, freq, ns) if route == "resident"
                                else wl._run_resident(s, seeds, tables, T, freq, ns, fit))
            how["resident"] = "gate" if route == "resident" else "private launcher"
        if tiles:
            runs["tiled"] = (wl.wl_sweeps(s, seeds, tables, T, freq, ns) if route == "tiled"
                             else wl._run_tiled(s, seeds, tables, T, freq, ns, tiles))
            how["tiled"] = "gate" if route == "tiled" else "private launcher"
        torch.cuda.synchronize()
        for r, got in runs.items():
            same, err = _equal_all(got, want)
            check(same, f"{name}: {r} != plain (max |diff| {err})")
            worst[r] = max(worst[r], err)
            if r != "multi":
                same, err = _equal_all(got, runs["multi"])
                check(same, f"{name}: {r} != multi-launch (max |diff| {err})")
        got = runs["multi"]
        moved = float((got[0] != s).float().mean())
        check(moved > 0.05, f"{name}: only {moved:.4f} of the spins moved")
        frozen = float((got[0] == got[0][:, :, :1]).all(2).float().mean())
        check("high K_tau" not in name or frozen > 0.3, f"{name}: only {frozen:.3f} of lines constant in tau")
        print(f"compare-wl: {name}: " + " == ".join(f"{r} ({how[r]})" for r in runs)
              + f" == plain, bit-identical (spins, statistics{', samples' if ns else ''}); the gate picks {route}; "
              f"resident plan {fit}, tiled plan {tiles}; {moved:.3f} of spins moved, "
              f"{frozen:.3f} of lines constant in tau", flush=True)
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
    check(counts == counts_only(wl_tiled=T), f"launch counts {counts}, want wl_tiled {T} only (one a sweep)")
    check(es.shape == (R,) and es.dtype == np.float64, f"energies {es.shape} {es.dtype}")
    check(st.shape == (R, nvars) and st.dtype == np.bool_, f"states {st.shape} {st.dtype}")
    check(np.isfinite(es).all(), "non-finite energies")
    e = es.mean() / nvars
    # the ground state is near -2.13 per site; 200 sweeps from a random start
    # leave domain walls, which cost at most a few tenths per site
    check(-2.5 < e < -1.0, f"e/site {e} outside (-2.5, -1.0)")
    print(f"main-quantum: Lattice.run_quantum_monte_carlo({WL_BETA}, {T}, {R}) on the 256^2 torus, "
          f"L_tau={WL_LTAU}: {counts['wl_tiled']} tiled launches, 0 others, {dt:.3f} s host wall, e/site={e:.6f}",
          flush=True)
    return counts["wl_tiled"]


def phase_main_quantum_sampling(dev):
    """The sampling path through the user's entry point at the 256^2 torus
    (the tiled kernel's sampling mode); returns the launch count."""
    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
    from pyisingmontecarlo_tpu_torch.ops import wl

    T, freq, (dense, nvars, R) = 20, 5, TORUS
    lat = Lattice(grid_2d_edges(256, 256, -1.0), seed_gen=1, device=dev)
    lat.set_transverse_field(WL_GAMMA)
    reset_counts()
    t0 = time.perf_counter()
    es, ss = lat.run_quantum_monte_carlo_sampling(WL_BETA, T, R, sampling_freq=freq)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    check(counts == counts_only(wl_tiled=T), f"launch counts {counts}, want wl_tiled {T} only (one a sweep)")
    check(es.shape == (R,) and es.dtype == np.float64 and np.isfinite(es).all(), f"energies {es.shape} {es.dtype}")
    check(ss.shape == (R, T // freq, nvars) and ss.dtype == np.bool_, f"samples {ss.shape} {ss.dtype}")
    e = es.mean() / nvars
    # 20 sweeps from a random start: ordering has begun, far from the ground state's -2.13
    check(-2.5 < e < -0.5, f"e/site {e} outside (-2.5, -0.5)")
    print(f"main-quantum-sampling: Lattice.run_quantum_monte_carlo_sampling({WL_BETA}, {T}, {R}, freq={freq}) on "
          f"the 256^2 torus: {counts['wl_tiled']} tiled launches, 0 others, {dt:.3f} s host wall, e/site={e:.6f}, "
          f"{ss.shape[1]} samples per replica", flush=True)
    return counts["wl_tiled"]


def phase_main_quantum_long(dev):
    """The worldline paths through the user's entry points on a 64^2 torus at
    L_tau = 800, where no tile fits and the multi-launch kernels sweep: 5
    plain sweeps, then 4 sampled every 2; returns the two launch counts."""
    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch.engines.worldline import choose_ltau
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
    from pyisingmontecarlo_tpu_torch.ops import wl

    (dense, nvars, R), side = LONG, LONG[0][1]
    check(choose_ltau(LONG_BETA, WL_GAMMA) == LONG_LTAU, "L_tau")
    lat = Lattice(grid_2d_edges(side, side, -1.0), seed_gen=2, device=dev)
    lat.set_transverse_field(WL_GAMMA)
    out = []
    for T, freq in ((5, 0), (4, 2)):
        reset_counts()
        t0 = time.perf_counter()
        if freq:
            es, ss = lat.run_quantum_monte_carlo_sampling(LONG_BETA, T, R, sampling_freq=freq)
            check(ss.shape == (R, T // freq, nvars) and ss.dtype == np.bool_, f"samples {ss.shape} {ss.dtype}")
        else:
            es, st = lat.run_quantum_monte_carlo(LONG_BETA, T, R)
            check(st.shape == (R, nvars) and st.dtype == np.bool_, f"states {st.shape} {st.dtype}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        want = counts_only(wl=wl.LAUNCHES_PER_SWEEP * T)
        check(counts == want, f"launch counts {counts}, want {want} (multi-launch)")
        check(es.shape == (R,) and es.dtype == np.float64 and np.isfinite(es).all(), f"energies {es.shape}")
        e = es.mean() / nvars
        # a few sweeps from a random start: far from the ground state's -2.13, below the random state's ~0
        check(-2.5 < e < 0.5, f"e/site {e} outside (-2.5, 0.5)")
        print(f"main-quantum-long: Lattice.run_quantum_monte_carlo{'_sampling' if freq else ''}({LONG_BETA}, {T}, "
              f"{R}{', freq=' + str(freq) if freq else ''}) on the {side}^2 torus, L_tau={LONG_LTAU}: {counts['wl']} "
              f"multi-launch launches, 0 others, {dt:.3f} s host wall, e/site={e:.6f}", flush=True)
        out.append(counts["wl"])
    return tuple(out)


def chain_energy(n, beta, gamma, j=1.0):
    """<E>/site of the periodic TFIM ring -J sum sz sz - Gamma sum sx (n even),
    exactly, from its free fermions: Z = (Z_A+ + Z_A- + Z_P+ - Z_P-) / 2 over
    the antiperiodic (k = 2 pi (m + 1/2) / n) and periodic (k = 2 pi m / n)
    modes, with Z_X+ = prod 2 cosh(beta e_k / 2), Z_X- = prod 2 sinh(beta e_k / 2),
    e_k = 2 sqrt(J^2 + Gamma^2 - 2 J Gamma cos k), and the periodic zero mode
    signed, e_0 = 2 (Gamma - J); <E> = -d ln Z / d beta by a central difference.
    In logs throughout, log 2 cosh x = |x| + log1p(e^(-2|x|)) and
    log 2 |sinh x| = |x| + log(-expm1(-2|x|)), so that beta e_k / 2 past 710 (the
    128-ring at beta = 512) does not overflow. phase_physics_wl checks it
    against dense diagonalization."""
    def ln_z(b):
        ea = 2 * np.sqrt(j * j + gamma * gamma - 2 * j * gamma * np.cos(2 * np.pi * (np.arange(n) + 0.5) / n))
        ep = 2 * np.sqrt(j * j + gamma * gamma - 2 * j * gamma * np.cos(2 * np.pi * np.arange(n) / n))
        ep[0] = 2 * (gamma - j)
        xa, xp = np.abs(b * ea / 2), np.abs(b * ep / 2)
        with np.errstate(divide="ignore"):  # a zero mode: sinh 0 = 0, Z_P- = 0
            logs = [(xa + np.log1p(np.exp(-2 * xa))).sum(), (xa + np.log(-np.expm1(-2 * xa))).sum(),
                    (xp + np.log1p(np.exp(-2 * xp))).sum(), (xp + np.log(-np.expm1(-2 * xp))).sum()]
        top = max(logs)
        w = [np.exp(x - top) for x in logs]
        return np.log(0.5 * (w[0] + w[1] + w[2] - np.prod(np.sign(ep)) * w[3])) + top

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
    want = counts_only(wl_resident=2)  # one resident launch for the wait, one for the sampled sweeps
    check(counts == want, f"launch counts {counts}, want {want}")
    check(es.shape == (R,) and es.dtype == np.float64 and np.isfinite(es).all(), f"energies {es.shape} {es.dtype}")
    check(ss.shape == (R, T // freq, n) and ss.dtype == np.bool_, f"samples {ss.shape} {ss.dtype}")
    e, se = es.mean() / n, es.std(ddof=1) / np.sqrt(R) / n
    exact = chain_energy(n, WL_BETA, WL_GAMMA)
    # 4 standard errors plus the Trotter allowance of tests/test_worldline_exact.py
    check(abs(e - exact) < 4 * se + 0.03, f"e/site {e} vs exact {exact} (se {se})")
    m = np.abs(np.where(ss, 1.0, -1.0).mean(axis=2)).mean()
    print(f"main-chain: Lattice.run_quantum_monte_carlo_sampling({WL_BETA}, {T}, {R}, wait={wait}, freq={freq}) "
          f"on the 256-chain: {counts['wl_resident']} resident launches, 0 multi-launch, {dt:.3f} s host wall, "
          f"e/site={e:.6f} (exact {exact:.6f}, se {se:.6f}), <|m|> of the samples {m:.4f}", flush=True)
    return counts["wl_resident"]


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
    for b, g in ((400.0, 1.0), (400.0, 0.5)):  # beta e_k / 2 past 710: the logs' far branch
        cold = dense_tfim_energy(edges, 0.0, g, b, 6)
        check(abs(6 * chain_energy(6, b, g) - cold) < 1e-5, f"free-fermion ring energy at beta={b}, Gamma={g}: "
                                                            f"{6 * chain_energy(6, b, g)} != dense {cold}")
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


def _trace(fn):
    """torch.profiler's record of ``fn()`` on the card, with ``fn()`` run
    twice: the first call under the schedule's warm-up step, traced and
    dropped, so that the device tracing has started before the recorded
    call's first launch (a window opened on the call itself can miss it)."""
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA], schedule=sched) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    return prof


def _launches(fn, names, want, tries=3):
    """(the _trace of ``fn()`` that recorded the most launches of the
    kernels ``names``, as text those launches beside ``want``, the wrapper's
    count). The profiler drops records, even after a warm-up step (on an
    H100: 105 of 140 launches in one trace, 65 to 77 of 80 in each of three
    traces of one process), and never adds them, so up to ``tries`` traces
    are taken until one records ``want``, and no trace may record more than
    the wrapper counts; a trace with no device time counts 0, and 'not
    recorded' when none records any."""
    best, counts = None, []
    for _ in range(tries):
        prof = _trace(fn)
        dev_t = _device_times(prof, names)
        if dev_t is None:
            counts.append(0)
            best = best or prof
            continue
        got = {k: len(v) for k, v in dev_t[0].items()}
        check(sum(got.values()) <= want, f"the profiler recorded {got} launches, the wrapper counts {want}")
        counts.append(sum(got.values()))
        if counts[-1] > max(counts[:-1], default=0):
            best = prof
        if counts[-1] == want:
            break
    if not max(counts):
        return best, "launches not recorded"
    return best, (f"{max(counts)} launches recorded, the wrapper counts {want}"
                  + (f" (traces: {counts})" if len(counts) > 1 else ""))


def site_lanes(L):
    """The threads a time line of the multi-launch site phases at L_tau =
    ``L`` (csrc/worldline.cuh, site_lanes)."""
    from pyisingmontecarlo_tpu_torch import _kernels

    return _kernels.load().pmc_site_lanes(L)


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



def _ladder_edges(kind, size):
    """The union edges (ea, eb) of a ring or torus ladder, as numpy arrays."""
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges

    if kind == "ring":
        return np.arange(size), (np.arange(size) + 1) % size
    g = grid_2d_edges(size, size)
    return np.array([a for (a, _), _ in g]), np.array([b for (_, b), _ in g])


def _ladder_inputs(kind, size, jv, betas, gammas, hs, L, T, seed, dev):
    """Random worldlines constant along tau, per-sweep seeds [T, R] from a
    split key chain, the planes, and the union edges as int32 device arrays."""
    from pyisingmontecarlo_tpu_torch.ops import ladder
    from pyisingmontecarlo_tpu_torch.rng import key_data_from_seeds, random_states
    from pyisingmontecarlo_tpu_torch.tempering import key_tables

    nvars = size if kind == "ring" else size * size
    ea, eb = _ladder_edges(kind, size)
    R = len(betas)
    kd = key_data_from_seeds(np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64))
    s = torch.from_numpy(random_states(kd, nvars)).to(dev)[:, :, None].expand(R, nvars, L).contiguous()
    seeds = torch.from_numpy(key_tables(kd, kd[0], T, 2**31 - 1)[0]).to(dev)
    planes = ladder.build_planes(kind, size, nvars, ea, eb, jv, betas, gammas, hs, L, dev)
    edges = tuple(torch.from_numpy(e.astype(np.int32)).to(dev) for e in (ea, eb))
    return s, seeds, planes, edges


def phase_compare_ladder(dev):
    """Ladder kernels vs the plain version on the card, in states and swap
    features: the route the gate picks (or the resident kernel through its
    private launcher where it fits but the gate leaves the shape to the
    multi-launch kernels) and the multi-launch kernels, each against the plain
    version and against each other (the multi-launch features from
    pt_swap_features; at the glass80.pt cell's shape also from a launch at T
    = 0, which sweeps nothing); returns (largest |difference| of the
    multi-launch kernels, of the resident kernel)."""
    from pyisingmontecarlo_tpu_torch._kernels import device_limits
    from pyisingmontecarlo_tpu_torch.ops import ladder, wl

    lim = device_limits(dev)
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
        ("L_tau=4 ring 8 R=1 h=0.2", "ring", 8, np.full(8, -1.0), [0.3], [1.0], [0.2], 4, 5),
        ("odd R: torus 12^2 +-J R=5 h=-0.2", "torus", 12, glass, np.geomspace(0.5, 2.0, 5), [1.0] * 5, [-0.2] * 5,
         40, 3),
        ("torus 24^2 +-1 R=3", "torus", 24, rng.choice([-1.0, 1.0], 2 * 24 * 24), [0.8, 1.2, 1.6], [1.0] * 3,
         [0.0] * 3, 40, 3),
        ("torus 48^2 R=2 (fits; the gate leaves it to the multi-launch kernels)", "torus", 48,
         np.full(2 * 48 * 48, -1.0), [1.0, 1.5], [1.0] * 2, [0.1] * 2, 40, 3),
        (f"bench shape torus 12^2 +-J R={PT_R} L_tau={PT_LTAU}", "torus", 12, glass, bench, [1.0] * PT_R,
         [0.0] * PT_R, PT_LTAU, 4),
        (f"wide ladder torus 64^2 +-J R={PT_R} L_tau={PT_LTAU} (main-tempering-wide's shape)", "torus", 64,
         np.array([j for _, j in pt_edges(64)]), bench, [1.0] * PT_R, [0.0] * PT_R, PT_LTAU, 2),
        (f"glass torus {GLASS80_SIDE}^2 +-J R={PT_R} L_tau={PT_LTAU} (the glass80.pt cell's shape)", "torus",
         GLASS80_SIDE, np.array([j for _, j in pt_edges(GLASS80_SIDE)]), bench, [1.0] * PT_R, [0.0] * PT_R,
         PT_LTAU, 2),
    ]
    # the multi-launch route's lengths, each cluster group size fk_group picks: L_tau = 700, 800, 974 (not a
    # multiple of 32), 3906 and 4096, rings and +-J tori (the 32^2 torus at 974 and the 16^2 torus at 3906 stay
    # inside the TPU kernel's gate of 10^6 spins a replica); dtau * Gamma = 0.001 or less freezes lines whole
    cases += [
        ("multi-launch L=700: ring 64 R=3 h", "ring", 64, np.full(64, -1.0), [30.0, 35.0, 40.0], [1.0] * 3,
         [0.1, 0.0, -0.1], 700, 2),
        ("multi-launch L=800: torus 16^2 +-J R=2 h", "torus", 16, rng.choice([-1.0, 1.0], 2 * 16 * 16), [40.0, 30.0],
         [1.0, 1.0], [0.0, 0.2], 800, 2),
        ("multi-launch L=974: torus 32^2 +-J R=2", "torus", 32, rng.choice([-1.0, 1.0], 2 * 32 * 32), [48.7, 40.0],
         [1.0, 0.8], [0.1, 0.0], 974, 2),
        ("multi-launch L=3906: torus 16^2 R=2", "torus", 16, np.full(2 * 16 * 16, -1.0), [195.3, 150.0], [1.0] * 2,
         [0.0, 0.1], 3906, 2),
        ("multi-launch L=800, high K_tau (lines frozen whole): ring 64 R=3", "ring", 64, np.full(64, 0.7),
         [40.0] * 3, [0.02, 0.03, 0.05], [0.2, 0.0, -0.1], 800, 3),
        ("multi-launch L=4096, high K_tau: ring 64 R=2", "ring", 64, np.full(64, -1.0), [40.0, 40.0], [0.02, 0.01],
         [0.2, 0.0], 4096, 2),
    ]
    # where ladder_site's indexing could go wrong: its lanes a line (site_lanes): 4 at L_tau = 62 (31 pairs), 8 at
    # 66 (33), 16 at 130 (65), a warp in two chunks at 514 (257 pairs, the last chunk one pair); a row of color lines
    # that is not a multiple of the lines a block holds (15 on the 30-ring against 32 and 8, 7 on the 14^2 torus
    # against 16, 5 on the 10^2 torus against 4); odd R
    cases += [
        ("multi-launch L=62 (2 mod 4): ring 30 R=3 h", "ring", 30, np.full(30, -1.0), [2.5, 3.1, 3.7], [1.0] * 3,
         [0.1, 0.0, -0.1], 62, 3),
        ("multi-launch L=66 (2 mod 4): torus 14^2 +-J R=3 h", "torus", 14, rng.choice([-1.0, 1.0], 2 * 14 * 14),
         [2.5, 3.3, 4.0], [1.0] * 3, [0.0, 0.2, 0.0], 66, 3),
        ("multi-launch L=130: ring 30 R=3 h", "ring", 30, rng.choice([-1.0, 1.0], 30), [5.0, 6.5, 8.0], [1.0] * 3,
         [0.1, 0.0, -0.1], 130, 3),
        ("multi-launch L=514: torus 10^2 +-J R=3 h", "torus", 10, rng.choice([-1.0, 1.0], 2 * 10 * 10),
         [20.0, 25.7, 30.0], [1.0] * 3, [0.0, 0.1, -0.2], 514, 3),
    ]
    worst = {"multi": 0, "resident": 0}
    for k, (name, kind, size, jv, betas, gammas, hs, L, T) in enumerate(cases):
        s, seeds, planes, edges = _ladder_inputs(kind, size, jv, betas, gammas, hs, L, T, 200 + k, dev)
        nvars = s.shape[1]
        pbytes = ladder.param_bytes(kind, nvars)
        R = s.shape[0]
        plan, fit = wl.resident_plan(nvars, L, R, pbytes, *lim), wl.resident_plan(nvars, L, R, pbytes, *lim, None)
        x, feats = ladder.ladder_sweeps_reference(s, seeds, planes, T, edges)
        want = (x, *feats)
        runs = {"multi": ladder._run_multi(s, seeds, planes, T, edges=edges)}  # features from pt_swap_features
        if plan:
            runs["resident"] = ladder.ladder_sweeps(s, seeds, planes, T, edges)  # the wrapper's own route
        elif fit:
            runs["resident"] = ladder._run_resident(s, seeds, planes, T, edges, fit)
        torch.cuda.synchronize()
        flat = {route: (y, *f) for route, (y, f) in runs.items()}
        for route, got in flat.items():
            same, err = _equal_all(got, want)
            check(same, f"{name}: {route} != plain (max |diff| {err}, "
                        f"{int((got[0] != want[0]).sum())} of {want[0].numel()} spins)")
            worst[route] = max(worst[route], err)
        if "resident" in flat:
            same, err = _equal_all(flat["resident"], flat["multi"])
            check(same, f"{name}: resident != multi-launch (max |diff| {err})")
        if "glass80.pt" in name:  # the swept state's features alone: the C entry at T = 0, one launch, no sweep
            y, feats = runs["multi"]
            before = ladder.ladder_sweeps.feature_launches
            y0, feats0 = ladder._run_multi(y, seeds, planes, 0, edges=edges)
            torch.cuda.synchronize()
            check(ladder.ladder_sweeps.feature_launches == before + 1, f"{name}: T = 0 launched "
                  f"{ladder.ladder_sweeps.feature_launches - before} pt_swap_features, want 1")
            same, err = _equal_all((y0, *feats0), (y, *feats))
            check(same, f"{name}: the features of the C entry at T = 0 != the sweeping call's (max |diff| {err})")
        got = runs["multi"][0]
        moved = float((got != s).float().mean())
        check(moved > 0.01, f"{name}: only {moved:.4f} of the spins moved")
        frozen = float((got == got[:, :, :1]).all(2).float().mean())
        check("high K_tau" not in name or frozen > 0.3, f"{name}: only {frozen:.3f} of lines constant in tau")
        route = ("resident (gate) == multi-launch" if plan else
                 "resident (private launcher) == multi-launch" if fit else "multi-launch (does not fit)")
        route += f" (group {cluster_group(L)})"
        if "glass80.pt" in name:
            route += "; the features again at T = 0"
        print(f"compare-ladder: {name}, T={T}: {route} == plain, bit-identical (spins, features); resident plan "
              f"{plan or fit}; {moved:.3f} of spins moved, {frozen:.3f} of lines constant in tau", flush=True)
    return worst["multi"], worst["resident"]


def block_edge(dev):
    """The longest L_tau whose line fits one block of the multi-launch cluster
    phase (fk_line) on this card; one more slice pair takes fk_long_*."""
    from pyisingmontecarlo_tpu_torch._kernels import device_limits
    from pyisingmontecarlo_tpu_torch.ops import wl

    limit = device_limits(dev)[0]
    L = 4096
    while not wl.cluster_long(L + 2, limit):
        L += 2
    return L


def phase_compare_longline(dev):
    """The multi-launch kernels vs their plain version on the card, bit for
    bit, at L_tau past 4096: the worldline kernels in plain and sampling mode
    at L_tau = 4098, 5120, 10,240, the longest line one block holds, one pair
    past it, 40,960 and 2^20 (the 4-ring at the gate's edge), with lines frozen
    whole at high K_tau; the ladder kernels (states and swap features) at
    5120, 40,960 and 250,000 (the 4-ring at the gate's edge). Returns
    {"wl": largest |difference|, "ladder": ...}."""
    from pyisingmontecarlo_tpu_torch._kernels import device_limits
    from pyisingmontecarlo_tpu_torch.ops import ladder, wl

    lim = device_limits(dev)
    edge = block_edge(dev)
    cases = []  # name, dense, nvars, R, L_tau, T, beta, gamma, h, freq, nsamples
    for dense, nvars, R, L in ((("torus", 8, -1.0), 64, 2, 4098), (("ring", 8, -1.0), 8, 3, 5120),
                               (LL[0], LL[1], 2, LL_LTAU), (("ring", 16, -1.0), 16, 2, edge),
                               (("ring", 16, -1.0), 16, 2, edge + 2), (("ring", 16, -1.0), 16, 2, 40960),
                               (("ring", 4, -1.0), 4, 2, 1 << 20)):
        beta = L / 20.0  # dtau = 0.05, Gamma = 1
        cases.append((f"{dense[0]} {dense[1]} R={R} L={L} T=2", dense, nvars, R, L, 2, beta, 1.0, 0.1, 0, 0))
        cases.append((f"{dense[0]} {dense[1]} R={R} L={L} sampling freq=1 nsamples=2 T=3", dense, nvars, R, L, 3,
                      beta, 1.0, 0.0, 1, 2))
    cases += [  # beta = 1, Gamma = 0.02: dtau * Gamma below 1e-6, lines frozen whole and summed in XLA's order
        # (three levels of windows at 2^20), a line's dE of order 1, so that lines flip
        ("ring 16 R=2 L=40960 high K_tau (lines frozen whole) T=2", ("ring", 16, 0.7), 16, 2, 40960, 2, 1.0,
         0.02, 0.2, 0, 0),
        ("ring 4 R=2 L=1048576 high K_tau (lines frozen whole) T=2", ("ring", 4, 0.7), 4, 2, 1 << 20, 2, 1.0,
         0.02, 0.2, 0, 0),
    ]
    worst = {"wl": 0, "ladder": 0}
    for k, (name, dense, nvars, R, L, T, beta, gamma, h, freq, ns) in enumerate(cases):
        check(wl.gate(dense, nvars, L, R) is None, f"{name}: the gate refuses it")
        check(wl.choose_route(dense[0], dense[1], nvars, L, R, *lim)[0] == "multi", f"{name}: not multi-launch")
        s, seeds = _wl_inputs(dense, nvars, R, 400 + k, dev, L)
        tables = wl.make_tables(dense, nvars, beta, gamma, h, L, dev)
        want = wl.wl_sweeps_reference(s, seeds, tables, T, freq, ns)
        reset_counts()
        got = wl.wl_sweeps(s, seeds, tables, T, freq, ns)
        torch.cuda.synchronize()
        counts = read_counts()
        long = wl.cluster_long(L, lim[0])
        check(counts == (counts_only(wl=3 * T, wl_long=wl.LONG_LAUNCHES_PER_SWEEP * T) if long
                         else counts_only(wl=wl.LAUNCHES_PER_SWEEP * T)), f"{name}: launch counts {counts}")
        same, err = _equal_all(got, want)
        check(same, f"{name}: multi-launch != plain (max |diff| {err}, {int((got[0] != want[0]).sum())} spins)")
        worst["wl"] = max(worst["wl"], err)
        moved = float((got[0] != s).float().mean())
        check(moved > 0.01, f"{name}: only {moved:.4f} of the spins moved")
        frozen = float((got[0] == got[0][:, :, :1]).all(2).float().mean())
        check("high K_tau" not in name or frozen > 0.3, f"{name}: only {frozen:.3f} of lines constant in tau")
        how = "fk_long_* (past one block)" if long else f"fk_line, group {cluster_group(L)}"
        print(f"compare-longline: wl {name}: multi-launch ({how}, site lanes {site_lanes(L)}) == plain, "
              f"bit-identical (spins, statistics{', samples' if ns else ''}); launches {counts['wl']} + "
              f"{counts['wl_long']} fk_long; {moved:.3f} of spins moved, {frozen:.3f} of lines constant in tau",
              flush=True)
    glass = np.array([j for _, j in pt_edges(PT_SIDE)])
    lcases = [  # name, kind, size, J, betas, gammas, hs, L_tau, T
        (f"torus 12^2 +-J R=4 L={LLPT_LTAU} (main-tempering-longline's lattice)", "torus", 12, glass,
         [2.0, 20.0, 100.0, LLPT_BETA], [1.0] * 4, [0.0, 0.1, 0.0, -0.1], LLPT_LTAU, 2),
        ("ring 16 R=2 L=40960", "ring", 16, np.random.default_rng(3).choice([-1.0, 1.0], 16), [1500.0, 2048.0],
         [1.0, 1.0], [0.1, 0.0], 40960, 2),
        ("ring 16 R=2 L=40960 high K_tau (lines frozen whole)", "ring", 16, np.full(16, 0.7), [1.0] * 2,
         [0.02, 0.01], [0.2, 0.0], 40960, 2),
        ("ring 4 R=2 L=250000 (the gate's edge)", "ring", 4, np.full(4, -1.0), [10000.0, 12500.0], [1.0, 1.0],
         [0.0, 0.1], 250000, 2),
    ]
    for k, (name, kind, size, jv, betas, gammas, hs, L, T) in enumerate(lcases):
        s, seeds, planes, edges = _ladder_inputs(kind, size, jv, betas, gammas, hs, L, T, 500 + k, dev)
        nvars, R = s.shape[1], s.shape[0]
        check(ladder.gate((kind, size), nvars, L, R) is None, f"{name}: the gate refuses it")
        check(not wl.resident_plan(nvars, L, R, ladder.param_bytes(kind, nvars), *lim), f"{name}: resident")
        x, feats = ladder.ladder_sweeps_reference(s, seeds, planes, T, edges)
        reset_counts()
        y, gfeats = ladder.ladder_sweeps(s, seeds, planes, T, edges)
        torch.cuda.synchronize()
        counts = read_counts()
        long = wl.cluster_long(L, lim[0])
        check(counts == (counts_only(ladder=2 * T, ladder_long=wl.LONG_LAUNCHES_PER_SWEEP * T) if long
                         else counts_only(ladder=ladder.LAUNCHES_PER_SWEEP * T)), f"{name}: launch counts {counts}")
        same, err = _equal_all((y, *gfeats), (x, *feats))
        check(same, f"{name}: multi-launch != plain (max |diff| {err}, {int((y != x).sum())} spins)")
        worst["ladder"] = max(worst["ladder"], err)
        moved = float((y != s).float().mean())
        check(moved > 0.01, f"{name}: only {moved:.4f} of the spins moved")
        frozen = float((y == y[:, :, :1]).all(2).float().mean())
        check("high K_tau" not in name or frozen > 0.3, f"{name}: only {frozen:.3f} of lines constant in tau")
        how = "fk_long_* (past one block)" if long else f"fk_line, group {cluster_group(L)}"
        print(f"compare-longline: ladder {name}, T={T}: multi-launch ({how}) == plain, bit-identical (spins, "
              f"features); launches {counts['ladder']} + {counts['ladder_long']} fk_long; {moved:.3f} of spins moved, "
              f"{frozen:.3f} of lines constant in tau", flush=True)
    return worst


def _pick(chunks, R):
    """The replicas that compare-replicas holds: the first and the last, and
    those on each side of every chunk boundary."""
    return sorted({0, R - 1} | {x for a, _ in chunks[1:] for x in (a - 1, a)})


def _rows_of(planes, it):
    """Replicas ``it`` of a ladder's parameter planes."""
    return planes._replace(**{k: getattr(planes, k)[it].contiguous() for k in ("j", "dt", "kt", "h", "pb")})


def phase_compare_replicas(dev):
    """The kernels at replica counts past one launch's limits
    (``ops/replicas.py``: 65,535 replicas on a grid's y or z axis, fewer than
    2^31 spins a launch of fk_long_*): each case's call through the wrapper
    runs in chunks of replicas (launch counts checked), and the replicas of
    ``_pick`` (each side of every chunk boundary, the first and the last) are
    held bit for bit against a call of those replicas alone on the kernel and
    against the plain version for them. The square torus (1024^2 at R = 2048,
    bench.py's lattice at 2^31 spins, and 32^2 at R = 65,600 in sampling and
    explicit-randoms mode), the worldline (64^2 at L_tau = 800, R = 656, 2.15e9
    spins; the 4-ring at L_tau = 2^20, R = 512, on fk_long_*; the 4-ring at
    L_tau = 4100, R = 65,600, sampling), the ladder (the 4-ring at 4100, R =
    65,600; the 12^2 +-J glass at 5120, R = 2913), then through the entry
    points: LatticeTempering on that glass ladder, 2 sweeps with swaps, and
    QmcIsing on the 64^2 torus at R = 656, both on the kernels. Prints chunks
    and launches of each call."""
    from pyisingmontecarlo_tpu_torch import LatticeTempering, QmcIsing
    from pyisingmontecarlo_tpu_torch._kernels import device_limits
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges
    from pyisingmontecarlo_tpu_torch.ops import ladder, replicas, sq2d, wl
    from pyisingmontecarlo_tpu_torch.ops.lattice2d import random_states_2d
    from pyisingmontecarlo_tpu_torch.rng import replica_seeds_i32

    lim = device_limits(dev)

    def call(fn):
        out = fn()
        torch.cuda.synchronize()
        return out, read_counts()

    def hold(name, big, alone, plain, chunks, counts, want, idx, moved):
        check(counts == want, f"{name}: launch counts {counts}, want {want}")
        same, err = _equal_all(big, alone)
        check(same, f"{name}: replicas {idx} of the whole call != a call of them alone (max |diff| {err})")
        same, err = _equal_all(alone, plain)
        check(same, f"{name}: the kernel != plain for replicas {idx} (max |diff| {err})")
        check(moved > 0.01, f"{name}: only {moved:.4f} of the spins moved")
        print(f"compare-replicas: {name}: {len(chunks)} chunk(s) of {sorted({b - a for a, b in chunks})} replicas; "
              f"launches {({k: v for k, v in counts.items() if v})}; replicas {idx} "
              f"== alone on the kernel == plain, bit-identical; {moved:.3f} of spins moved", flush=True)

    for k, (name, L, R, T, mode) in enumerate((
            ("torus 1024^2 R=2048 T=4 (bench.py's lattice, 2^31 spins)", BENCH_L, 2048, 4, "hash"),
            ("torus 32^2 R=65600 T=4 sampling every 2", 32, 65600, 4, "sampling"),
            ("torus 32^2 R=65600 T=4 explicit randoms", 32, 65600, 4, "explicit randoms"))):
        rng = np.random.default_rng(700 + k)
        seeds = torch.from_numpy(replica_seeds_i32(rng.integers(0, 2**64, R, dtype=np.uint64))).to(dev)
        s = random_states_2d(seeds, L)
        thr = sq2d.thresholds(np.full(T, 0.44, np.float32), -1.0, 0.0).to(dev)
        rb = (torch.from_numpy(rng.integers(-(2**31), 2**31, (2 * T, L, L // 2)).astype(np.int32)).to(dev)
              if mode == "explicit randoms" else None)
        freq = 2 if mode == "sampling" else None
        chunks = replicas.replica_chunks(R, L * L, "sq2d")
        plan = sq2d.sq2d_plan(L, R, *lim, rb is not None)
        reset_counts()
        big, counts = call(lambda: sq2d.sweeps_2d(s, seeds, thr, 3, rb, freq))
        idx = _pick(chunks, R)
        it = torch.tensor(idx, device=dev)
        sub = (s[it].contiguous(), seeds[it].contiguous(), thr, 3, rb, freq)
        alone, plain = sq2d.sweeps_2d(*sub), sq2d.sweeps_2d_reference(*sub)
        big, alone, plain = ((x if freq else (x,)) for x in (big, alone, plain))
        moved = float((big[0] != s).float().mean())
        hold(name, [x[it] for x in big], alone, plain, chunks, counts,
             counts_only(sq2d=len(chunks) * -(-T // plan[1])), idx, moved)
        del s, seeds, big
        torch.cuda.empty_cache()

    for k, (name, dense, nvars, R, L, T, freq, ns) in enumerate((
            ("torus 64^2 R=656 L=800 T=2 (2.15e9 spins)", LONG[0], LONG[1], 656, LONG_LTAU, 2, 0, 0),
            ("ring 4 R=512 L=2^20 T=2 (2^31 spins, fk_long_*)", ("ring", 4, -1.0), 4, 512, 1 << 20, 2, 0, 0),
            ("ring 4 R=65600 L=4100 sampling freq=1 nsamples=2 T=2", ("ring", 4, -1.0), 4, 65600, 4100, 2, 1, 2))):
        check(wl.gate(dense, nvars, L, R) is None, f"{name}: the gate refuses it")
        check(wl.choose_route(dense[0], dense[1], nvars, L, R, *lim)[0] == "multi", f"{name}: not multi-launch")
        long = wl.cluster_long(L, lim[0])
        chunks = replicas.replica_chunks(R, nvars * L, "long" if long else "multi")
        s, seeds = _wl_inputs(dense, nvars, R, 720 + k, dev, L)
        tables = wl.make_tables(dense, nvars, L / 20.0, 1.0, 0.1, L, dev)  # dtau = 0.05, Gamma = 1
        reset_counts()
        big, counts = call(lambda: wl.wl_sweeps(s, seeds, tables, T, freq, ns))
        n = len(chunks)
        want = (counts_only(wl=3 * T * n, wl_long=wl.LONG_LAUNCHES_PER_SWEEP * T * n) if long
                else counts_only(wl=wl.LAUNCHES_PER_SWEEP * T * n))
        idx = _pick(chunks, R)
        it = torch.tensor(idx, device=dev)
        sub = (s[it].contiguous(), seeds[it].contiguous(), tables, T, freq, ns)
        alone, plain = wl.wl_sweeps(*sub), wl.wl_sweeps_reference(*sub)
        moved = float((big[0] != s).float().mean())
        hold(f"wl {name}", [x[it] for x in big], alone, plain, chunks, counts, want, idx, moved)
        del s, seeds, big
        torch.cuda.empty_cache()

    glass = np.array([j for _, j in pt_edges(PT_SIDE)])
    for k, (name, kind, size, jv, R, L, betas) in enumerate((
            ("ring 4 R=65600 L=4100 T=2", "ring", 4, np.full(4, -1.0), 65600, 4100, np.geomspace(20.0, 205.0, 65600)),
            ("torus 12^2 +-J R=2913 L=5120 T=2 (2.15e9 spins)", "torus", PT_SIDE, glass, 2913, LLPT_LTAU,
             np.geomspace(0.2, LLPT_BETA, 2913)))):
        T = 2
        s, seeds, planes, edges = _ladder_inputs(kind, size, jv, betas, [1.0] * R, [0.0] * R, L, T, 740 + k, dev)
        nvars = s.shape[1]
        check(ladder.gate((kind, size), nvars, L, R) is None, f"{name}: the gate refuses it")
        check(not wl.resident_plan(nvars, L, R, ladder.param_bytes(kind, nvars), *lim), f"{name}: resident")
        long = wl.cluster_long(L, lim[0])
        chunks = replicas.replica_chunks(R, nvars * L, "long" if long else "multi")
        reset_counts()
        (y, feats), counts = call(lambda: ladder.ladder_sweeps(s, seeds, planes, T, edges))
        n = len(chunks)
        want = (counts_only(ladder=2 * T * n, ladder_long=wl.LONG_LAUNCHES_PER_SWEEP * T * n) if long
                else counts_only(ladder=ladder.LAUNCHES_PER_SWEEP * T * n))
        idx = _pick(chunks, R)
        it = torch.tensor(idx, device=dev)
        sub = (s[it].contiguous(), seeds[:, it].contiguous(), _rows_of(planes, it), T, edges)
        (ya, fa), (yp, fp) = ladder.ladder_sweeps(*sub), ladder.ladder_sweeps_reference(*sub)
        moved = float((y != s).float().mean())
        hold(f"ladder {name}", [y[it], *(f[it] for f in feats)], [ya, *fa], [yp, *fp], chunks, counts, want, idx,
             moved)
        del s, seeds, planes, y, feats
        torch.cuda.empty_cache()

    R, T = 2913, 2
    lt = LatticeTempering(pt_edges(PT_SIDE), seed=0, device=dev)
    for b in np.geomspace(0.2, LLPT_BETA, R):
        lt.add_graph(1.0, 0.0, float(b))
    check(lt._on_kernel() and lt._ltau() == LLPT_LTAU, "LatticeTempering: not the kernel route at L_tau 5120")
    reset_counts()
    t0 = time.perf_counter()
    states, es = lt.qmc_timesteps_sample(T, replica_swap_freq=1)
    dt = time.perf_counter() - t0
    counts = read_counts()
    check(counts["ladder"] > 0 and counts == counts_only(ladder=T * ladder.LAUNCHES_PER_SWEEP, keychain=2),
          f"LatticeTempering: launch counts {counts}")
    check(states.shape == (R, T, PT_SIDE**2) and np.isfinite(es).all(), f"LatticeTempering: {states.shape}")
    print(f"compare-replicas: LatticeTempering on the {PT_SIDE}^2 +-J glass, {R} rungs at geomspace(0.2, "
          f"{LLPT_BETA}), L_tau={LLPT_LTAU} (2.15e9 spins), qmc_timesteps_sample({T}, replica_swap_freq=1): "
          f"{counts['ladder']} ladder launches, the key tables' 2 threefry_chain, 0 others; {lt.get_total_swaps()} swaps accepted; {dt:.3f} s host "
          f"wall", flush=True)
    del lt, states
    torch.cuda.empty_cache()

    (_, nvars, _), side, R, T = LONG, LONG[0][1], 656, 2
    q = QmcIsing(grid_2d_edges(side, side, -1.0), WL_GAMMA, 0.0, num_experiments=R, seed=6, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    q.run_qmc(LONG_BETA, T)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    check(q._w.L == LONG_LTAU and q._w.on_kernel(), f"QmcIsing: L_tau {q._w.L}, on the kernel {q._w.on_kernel()}")
    check(counts["wl"] > 0 and counts == counts_only(wl=T * wl.LAUNCHES_PER_SWEEP), f"QmcIsing: counts {counts}")
    check(bool((q._w.s.abs() == 1).all()), "QmcIsing: spins not +-1")
    print(f"compare-replicas: QmcIsing on the {side}^2 torus, R={R}, run_qmc({LONG_BETA}, {T}) (L_tau="
          f"{LONG_LTAU}, {R * nvars * LONG_LTAU} spins): on the kernel, {counts['wl']} wl launches, 0 others; "
          f"{dt:.3f} s host wall", flush=True)
    del q
    torch.cuda.empty_cache()


def _path_profile(fn, names, want):
    """The trace of ``fn()`` (_launches) that recorded the most launches of
    the kernels ``names`` (the wrapper counts ``want``), and (the text of
    those launches, {kernel: launches}, the other device operations by name,
    device busy us, span us); the last four None where the profiler recorded
    no device time."""
    prof, counted = _launches(fn, names, want)
    dev_t = _device_times(prof, names, everything=True)
    if dev_t is None:
        return counted, None, None, None, None
    per, busy, span = dev_t
    others = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.name and not any(n in e.name for n in names):
            others[e.name[:60]] = others.get(e.name[:60], 0) + 1
    return counted, {k: len(v) for k, v in per.items() if k != "other"}, others, busy, span


def _path_line(counted, kernels, others, busy, span, sweeps):
    if kernels is None:
        return f"{counted}; device time not measured (the profiler recorded none)"
    return (f"{counted}; by kernel {kernels}; other device operations {sum(others.values())} ({others}); device "
            f"busy {busy:.1f} of {span:.1f} us, {busy / sweeps / 1e3:.5f} ms a sweep, "
            f"idle {100 * (1 - busy / span):.2f}%")


def phase_main_quantum_longline(dev, smi):
    """The worldline paths through the user's entry points at long time lines:
    the 128-ring TFIM at its critical point (LL: J = -1, Gamma = 1, beta =
    512, L_tau = 10,240, 64 replicas, an 84 MB int8 plane), run_quantum_monte_carlo
    (300 sweeps) and run_quantum_monte_carlo_sampling (300 sweeps after a
    wait of 300, every 10th sampled), on the multi-launch kernels (the
    cluster phase a block of 512 threads a line), against the exact
    free-fermion energy; the launches by kernel, the other device operations
    (the calls' set-up and results, no generic engine) and the idle share
    of a 20-sweep call (torch.profiler); then the 16-ring at beta = 2048
    (L_tau = 40,960, past one block: fk_long_*) through both entry points, 2
    sweeps each. Returns {"plain", "sampling", "long", "long-sampling":
    (wl launches, fk_long launches)}."""
    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch._kernels import device_limits
    from pyisingmontecarlo_tpu_torch.engines.worldline import choose_ltau
    from pyisingmontecarlo_tpu_torch.ops import wl

    (dense, n, R), beta = LL, LL_BETA
    check(choose_ltau(beta, WL_GAMMA) == LL_LTAU, "L_tau")
    lim = device_limits(dev)
    check(not wl.cluster_long(LL_LTAU, lim[0]), "the 128-ring's line does not fit one block")
    ring = [((i, (i + 1) % n), -1.0) for i in range(n)]
    exact = chain_energy(n, beta, WL_GAMMA)
    check(np.isfinite(exact), f"chain_energy({n}, {beta}) = {exact}")
    out = {}
    for key, T, wait, freq in (("plain", 300, 0, 0), ("sampling", 300, 300, 10)):
        lat = Lattice(ring, seed_gen=5, device=dev)
        lat.set_transverse_field(WL_GAMMA)
        reset_counts()
        t0 = time.perf_counter()
        if freq:
            es, ss = lat.run_quantum_monte_carlo_sampling(beta, T, R, sampling_wait_buffer=wait, sampling_freq=freq)
            check(ss.shape == (R, T // freq, n) and ss.dtype == np.bool_, f"samples {ss.shape} {ss.dtype}")
        else:
            es, st = lat.run_quantum_monte_carlo(beta, T, R)
            check(st.shape == (R, n) and st.dtype == np.bool_, f"states {st.shape} {st.dtype}")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        want = counts_only(wl=wl.LAUNCHES_PER_SWEEP * (T + wait))
        check(counts == want, f"launch counts {counts}, want {want} (multi-launch, fk_line)")
        check(es.shape == (R,) and es.dtype == np.float64 and np.isfinite(es).all(), f"energies {es.shape}")
        e, se = es.mean() / n, es.std(ddof=1) / np.sqrt(R) / n
        # 4 standard errors plus the Trotter allowance of tests/test_worldline_exact.py
        check(abs(e - exact) < 4 * se + 0.03, f"e/site {e} vs exact {exact} (se {se})")
        out[key] = (counts["wl"], 0)
        print(f"main-quantum-longline: Lattice.run_quantum_monte_carlo{'_sampling' if freq else ''}({beta}, {T}, "
              f"{R}{f', wait={wait}, freq={freq}' if freq else ''}) on the {n}-ring at Gamma = {WL_GAMMA}, "
              f"L_tau={LL_LTAU}, on {smi}: {counts['wl']} multi-launch launches (wl_site, wl_cluster, "
              f"wl_accumulate; cluster group {cluster_group(LL_LTAU)}), 0 others, {dt:.3f} s host wall = "
              f"{dt / (T + wait) * 1e3:.5f} ms a sweep; e/site={e:.6f} (exact {exact:.6f}, se {se:.6f})", flush=True)
    lat = Lattice(ring, seed_gen=6, device=dev)
    lat.set_transverse_field(WL_GAMMA)
    T = 20
    prof_line = _path_line(*_path_profile(lambda: lat.run_quantum_monte_carlo(beta, T, R),
                                          ("wl_site", "wl_cluster", "wl_accumulate"),
                                          wl.LAUNCHES_PER_SWEEP * T), T)
    print(f"main-quantum-longline: run_quantum_monte_carlo({beta}, {T}, {R}) profiled, on {smi}: {prof_line}",
          flush=True)
    side, beta16 = 16, 2048.0
    check(choose_ltau(beta16, WL_GAMMA) == 40960 and wl.cluster_long(40960, lim[0]), "the 16-ring's L_tau")
    lat = Lattice([((i, (i + 1) % side), -1.0) for i in range(side)], seed_gen=7, device=dev)
    lat.set_transverse_field(WL_GAMMA)
    for key, T, freq in (("long", 2, 0), ("long-sampling", 2, 1)):
        reset_counts()
        t0 = time.perf_counter()
        if freq:
            es, ss = lat.run_quantum_monte_carlo_sampling(beta16, T, 2, sampling_freq=freq)
            check(ss.shape == (2, T, side), f"samples {ss.shape}")
        else:
            es, st = lat.run_quantum_monte_carlo(beta16, T, 2)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = read_counts()
        want = counts_only(wl=3 * T, wl_long=wl.LONG_LAUNCHES_PER_SWEEP * T)
        check(counts == want, f"launch counts {counts}, want {want} (multi-launch, fk_long)")
        check(np.isfinite(es).all() and -2.5 < es.mean() / side < 0.5, f"energies {es}")
        out[key] = (counts["wl"], counts["wl_long"])
        print(f"main-quantum-longline: Lattice.run_quantum_monte_carlo{'_sampling' if freq else ''}({beta16}, {T}, 2"
              f"{', freq=1' if freq else ''}) on the {side}-ring, L_tau=40960: {counts['wl']} wl_site and "
              f"wl_accumulate launches and {counts['wl_long']} fk_long_* launches, 0 others, {dt:.3f} s host wall, "
              f"e/site={es.mean() / side:.6f}", flush=True)
    return out


def phase_main_tempering_longline(dev, smi):
    """The tempering path through the user's entry point at long time lines:
    benches/bench_tempering.py's 12^2 +-J glass, 64 rungs at geomspace(0.2,
    256, 64), Gamma = 1, so L_tau = 5120 (a 47 MB plane), on the multi-launch
    kernels (the cluster phase a block of 512 threads a line):
    qmc_timesteps_sample(200, replica_swap_freq=1), swaps accepted and <E>
    falling with beta; the launches by kernel, the other device operations
    and the idle share of a 10-sweep call (torch.profiler); then a 4-ring
    ladder with rungs up to beta = 12,500 (L_tau = 250,000, the gate's edge,
    past one block: fk_long_*), 2 sweeps. Returns {"wide": (ladder launches,
    0), "long": (ladder launches, fk_long launches)}."""
    from pyisingmontecarlo_tpu_torch import LatticeTempering
    from pyisingmontecarlo_tpu_torch._kernels import device_limits
    from pyisingmontecarlo_tpu_torch.ops import ladder, wl

    lim = device_limits(dev)
    lt = LatticeTempering(pt_edges(PT_SIDE), seed=0, device=dev)
    for b in np.geomspace(0.2, LLPT_BETA, PT_R):
        lt.add_graph(1.0, 0.0, float(b))
    m = lt._materialize()
    check(m["L"] == LLPT_LTAU and "planes" in m, f"L_tau {m['L']}, kernel route {'planes' in m}")
    check(not wl.cluster_long(LLPT_LTAU, lim[0]), "the ladder's line does not fit one block")
    T = 200
    reset_counts()
    t0 = time.perf_counter()
    states, es = lt.qmc_timesteps_sample(T, replica_swap_freq=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = counts_only(ladder=ladder.LAUNCHES_PER_SWEEP * T, keychain=2)
    check(counts == want, f"launch counts {counts}, want {want} (multi-launch, fk_line)")
    check(states.shape == (PT_R, T, PT_SIDE**2) and states.dtype == np.bool_, f"states {states.shape}")
    check(es.shape == (PT_R,) and np.isfinite(es).all(), f"energies {es.shape}")
    swaps = lt.get_total_swaps()
    check(swaps > 0, "no swap accepted")
    check(es[-8:].mean() < es[:8].mean(), f"<E> of the 8 highest betas {es[-8:].mean()} is not below that of the "
                                          f"8 lowest {es[:8].mean()}")
    out = {"wide": (counts["ladder"], 0)}
    print(f"main-tempering-longline: LatticeTempering.qmc_timesteps_sample({T}, replica_swap_freq=1) on the "
          f"{PT_SIDE}^2 +-J glass, {PT_R} rungs at geomspace(0.2, {LLPT_BETA}), L_tau={LLPT_LTAU}, on {smi}: "
          f"{counts['ladder']} multi-launch launches (ladder_site, ladder_cluster; cluster group "
          f"{cluster_group(LLPT_LTAU)}), the key tables' 2 threefry_chain, 0 others, {swaps} accepted swaps, {dt:.3f} s host wall = "
          f"{dt / T * 1e3:.5f} ms a sweep; <E> beta=0.2..0.3 {es[:8].mean():.4f}, beta=105..256 "
          f"{es[-8:].mean():.4f}", flush=True)
    T = 10
    prof_line = _path_line(*_path_profile(lambda: lt.qmc_timesteps_sample(T, replica_swap_freq=1),
                                          ("ladder_site", "ladder_cluster"), ladder.LAUNCHES_PER_SWEEP * T), T)
    print(f"main-tempering-longline: qmc_timesteps_sample({T}) profiled, on {smi}: {prof_line}", flush=True)
    ring4 = [((i, (i + 1) % 4), -1.0) for i in range(4)]
    lt = LatticeTempering(ring4, seed=1, device=dev)
    for b in (6000.0, 8000.0, 10000.0, 12500.0):
        lt.add_graph(1.0, 0.0, b)
    m = lt._materialize()
    check(m["L"] == 250000 and "planes" in m and wl.cluster_long(250000, lim[0]), f"the 4-ring's L_tau {m['L']}")
    T = 2
    reset_counts()
    t0 = time.perf_counter()
    states, es = lt.qmc_timesteps_sample(T, replica_swap_freq=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = counts_only(ladder=2 * T, ladder_long=wl.LONG_LAUNCHES_PER_SWEEP * T, keychain=2)
    check(counts == want, f"launch counts {counts}, want {want} (multi-launch, fk_long)")
    check(states.shape == (4, T, 4) and np.isfinite(es).all(), f"states {states.shape}, energies {es}")
    out["long"] = (counts["ladder"], counts["ladder_long"])
    print(f"main-tempering-longline: qmc_timesteps_sample({T}, replica_swap_freq=1) on a 4-ring ladder, rungs at "
          f"beta 6000 to 12500, L_tau=250000: {counts['ladder']} ladder_site launches and {counts['ladder_long']} "
          f"fk_long_* launches, the key tables' 2 threefry_chain, 0 others, {lt.get_total_swaps()} accepted swaps, {dt:.3f} s host wall", flush=True)
    return out


def phase_main_tempering(dev):
    """The tempering path through the user's entry point at the bench ladder;
    returns the launch count."""
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
    want = counts_only(ladder_resident=2500, keychain=4)  # one resident launch a sweep, two key chains a call
    check(counts == want, f"launch counts {counts}, want {want}")
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
          f"12^2 +-J glass, {PT_R} replicas, L_tau={PT_LTAU}: {counts['ladder_resident']} resident launches, "
          f"0 multi-launch, {swaps} accepted swaps; "
          f"host wall {wall[500][0]:.3f} s + {wall[2000][0]:.3f} s (materialize {setup:.3f} s; the seed and "
          f"uniform tables of 2000 sweeps {tables:.3f} s); slope {sweeps / dt:.2f} sweeps/s = "
          f"{attempts / dt:.1f} swap attempts/s (runs {wall}); <E> beta=0.2..0.26 {es[:8].mean():.4f}, "
          f"beta=2.3..3.0 {es[-8:].mean():.4f}", flush=True)
    return counts["ladder_resident"], sweeps / dt, attempts / dt


def phase_main_tempering_wide(dev):
    """The tempering path on the same ladder over a 64^2 +-J torus, whose
    plane (245 KB a replica) the gate leaves to the multi-launch kernels;
    returns the launch counts of the ladder kernels and of pt_swap_features."""
    from pyisingmontecarlo_tpu_torch.ops import ladder

    T, side = 5, 64
    lt = pt_ladder(dev, side=side)
    lt._materialize()
    reset_counts()
    features0 = ladder.ladder_sweeps.feature_launches
    t0 = time.perf_counter()
    states, es = lt.qmc_timesteps_sample(T, replica_swap_freq=1)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    want = counts_only(ladder=ladder.LAUNCHES_PER_SWEEP * T, keychain=2)
    check(counts == want, f"launch counts {counts}, want {want}")
    features = ladder.ladder_sweeps.feature_launches - features0
    check(features == T, f"{features} pt_swap_features launches, want {T} (one a one-sweep call)")
    check(states.shape == (PT_R, T, side * side) and states.dtype == np.bool_, f"states {states.shape}")
    check(es.shape == (PT_R,) and es.dtype == np.float64 and np.isfinite(es).all(), f"energies {es.shape}")
    print(f"main-tempering-wide: LatticeTempering.qmc_timesteps_sample({T}, replica_swap_freq=1) on a {side}^2 "
          f"+-J glass, {PT_R} replicas, L_tau={PT_LTAU}: {counts['ladder']} multi-launch launches and {features} "
          f"pt_swap_features, {lt.get_total_swaps()} accepted swaps, {dt:.3f} s host wall", flush=True)
    return counts["ladder"], features


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


# ----------------------------------------------------------------------------------------- the classical graph path

# the classical graph path's main call: BASELINE.json config 2 (benches/bench_configs.py:30-42), the annealing of
# the 48^2 triangular antiferromagnet (J = +1), 100 experiments, beta 0.1 -> 3.0; the depth cut from 4000 steps
TRI_L, TRI_R, TRI_SEED, TRI_T, TRI_T_FULL = 48, 100, 11, 200, 4000
# benches/bench_classical_graph.py's glass: a 4-regular +-J graph (two random Hamilton cycles, seed 7), 64
# replicas at beta 1.5; n = 4096 takes the dense coupling path, n = 16384 the ELL path (spin family there)
GLASS_NS, GLASS_R, GLASS_BETA = (4096, 16384), 64, 1.5
# blocks of a slot of the chain by kind (rng.KEY_PLAIN, KEY_WORM, KEY_CLUSTER, KEY_FAN, KEY_SLICE, KEY_BITS): the
# split, and the sub-key's work (a fan of m: 2 a split of its inner chain; bits: 1 a word)
CHAIN_BLOCKS = {0: lambda m: 2, 1: lambda m: 8, 2: lambda m: 7, 3: lambda m: 2 + 2 * m, 4: lambda m: 8,
                5: lambda m: 2 + m}


def _slot_blocks(slot):
    from pyisingmontecarlo_tpu_torch.rng import _slot

    kind, m = _slot(slot)
    return CHAIN_BLOCKS[kind](m)


def tri_plan():
    """The key plan of the triangular annealing's default step (Lattice._move_args)."""
    from pyisingmontecarlo_tpu_torch.engines import classical as ce
    from pyisingmontecarlo_tpu_torch.graph import compile_graph
    from pyisingmontecarlo_tpu_torch.models import triangular_edges

    ga = ce.device_graph_sorted(compile_graph(triangular_edges(TRI_L, j=1.0)), device="cpu")
    return ce.step_plan(ga, 1, 1, 1, False, 0)


def _keys(R, seed):
    from pyisingmontecarlo_tpu_torch.rng import key_data_from_seeds

    return key_data_from_seeds(np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64))


def phase_compare_keychain(dev):
    """threefry_chain against its numpy version, bit for bit: the main path's
    plan (200 steps x 29 slots x R = 100), a plan with worm and cluster
    slots at R = 1 over 2^16 splits and a plan of every slot kind at R = 100.
    Returns the largest |difference|."""
    from pyisingmontecarlo_tpu_torch.rng import key_tensor, threefry_chain, threefry_chain_reference

    kinds = tri_plan()
    check(len(kinds) == 29 and kinds.count(1) == 1, f"the triangular plan has {len(kinds)} slots: {kinds}")
    cases = (("main path", kinds, TRI_T, TRI_R, TRI_L**2, 3), ("worm and cluster, R=1", [0, 1, 0, 0, 2, 0, 0, 0],
             8192, 1, 100003, 4),
             ("every slot kind (fan and bits of m = 0 among them), R=100",
              [0, 1, 2, (3, 0), (3, 1), (3, 5), (4, 9), (4, 70000), (5, 0), (5, 33), 0], 50, 100, 1000, 6))
    err = 0
    for name, plan, T, R, nvars, seed in cases:
        kd = _keys(R, seed)
        t0 = time.perf_counter()
        want = threefry_chain_reference(kd, plan, T, nvars)
        plain_s = time.perf_counter() - t0
        got = threefry_chain(key_tensor(kd, dev), plan, T, nvars)
        torch.cuda.synchronize()
        got = [g.cpu().numpy() for g in got]
        want = [want[0], want[1], key_tensor(want[2], "cpu").numpy()]
        for g, w in zip(got, want):
            check(g.shape == w.shape, f"compare-keychain {name}: shape {g.shape} vs {w.shape}")
            err = max(err, int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max()) if g.size else 0)
        check(err == 0, f"compare-keychain {name}: threefry_chain != its numpy version (max |diff| {err})")
        print(f"compare-keychain: {name}: {T} steps x {len(plan)} slots x R={R} ({T * len(plan)} chained splits, "
              f"nvars {nvars}): seeds {got[0].shape}, worm starts {got[1].shape} and keys equal bit for bit "
              f"(numpy {plain_s:.3f} s)", flush=True)
    return err


# compare-key-tables' shapes: (name, keys, sweeps, swap period)
KEY_TABLE_CASES = (("glass80.pt's 64 rungs, a swap every sweep", 64, 500, 1),
                   ("33 rungs, past one block of 32, a swap every third sweep", 33, 200, 3),
                   ("16 rungs, half a block", 16, 500, 1))


def phase_compare_key_tables(dev):
    """LatticeTempering's key tables on the card (tempering.key_tables_device:
    threefry_chain with a plain slot a sweep, then a uniform slot a swap step
    on the swap key) against the numpy key_tables, bit for bit (seeds,
    uniforms, both advanced keys), at KEY_TABLE_CASES; then
    key_tables_device.launches over two calls of the 12^2 bench ladder (one a
    call) and its keys after them against the numpy chain's. Returns the
    largest |difference|."""
    from pyisingmontecarlo_tpu_torch import tempering as tt
    from pyisingmontecarlo_tpu_torch.rng import key_data_of, key_tensor

    err = 0
    for name, R, T, sf in KEY_TABLE_CASES:
        kd, sk = _keys(R, 40 + R), _keys(1, 41 + R)[0]
        t0 = time.perf_counter()
        want = tt.key_tables(kd, sk, T, sf)
        plain_ms = (time.perf_counter() - t0) * 1e3
        keys, swapkey = key_tensor(kd, dev), key_tensor(sk, dev)[0]
        got = tt.key_tables_device(keys, swapkey, T, sf)
        got = [got[0].cpu().numpy(), got[1].cpu().numpy().view(np.int32), key_data_of(got[2]), key_data_of(got[3])]
        want = [want[0], want[1].view(np.int32), want[2], want[3][None]]
        for g, w in zip(got, want):
            check(g.shape == w.shape, f"compare-key-tables {name}: shape {g.shape} vs {w.shape}")
            err = max(err, int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max()) if g.size else 0)
        check(err == 0, f"compare-key-tables {name}: key_tables_device != key_tables (max |diff| {err})")
        print(f"compare-key-tables: {name}: {T} sweeps x {R} keys, {T // sf} swap steps: seeds {got[0].shape}, "
              f"uniforms {got[1].shape} and both keys equal key_tables bit for bit (numpy key_tables "
              f"{plain_ms:.3f} ms)", flush=True)
    lt = pt_ladder(dev)
    m = lt._materialize()
    kd, sk = m["key_data"].copy(), lt._swapkey.copy()
    t0 = time.perf_counter()
    want = tt.key_tables(kd, sk, 2 * 20, 1, PT_R)
    plain_ms = (time.perf_counter() - t0) * 1e3
    tt.key_tables_device.launches = 0
    for _ in range(2):
        lt.qmc_timesteps_sample(20, replica_swap_freq=1)
    calls = tt.key_tables_device.launches
    check(calls == 2, f"compare-key-tables: key_tables_device.launches {calls} over two ladder calls, want 2")
    check(np.array_equal(m["key_data"], want[2]) and np.array_equal(lt._swapkey, want[3]),
          "compare-key-tables: the ladder's keys after two calls differ from the numpy chain's")
    print(f"compare-key-tables: the {PT_SIDE}^2 bench ladder ({PT_R} rungs): key_tables_device.launches {calls} over "
          f"two 20-sweep calls, keys after them equal the numpy chain's (numpy key_tables of those 40 sweeps "
          f"{plain_ms:.3f} ms)", flush=True)
    return err


def glass_edges(n, seed=7):
    """benches/bench_classical_graph.py's random_regular_pm_j(n, 2, seed)."""
    rng = np.random.default_rng(seed)
    seen, edges = set(), []
    for _ in range(2):
        perm = rng.permutation(n)
        for i in range(n):
            a, b = int(perm[i]), int(perm[(i + 1) % n])
            key = (min(a, b), max(a, b))
            if a != b and key not in seen:
                seen.add(key)
                edges.append(((a, b), 1.0 if rng.random() < 0.5 else -1.0))
    return edges


def _engine_case(dev, edges, R, T, moves, dense=None, bias=0.0, iw=None, energies=False, seed=1):
    """The graph engine's run on the card and on the CPU from one state and
    key set: (differing spins and key words, energies equal or None, dense path)."""
    from pyisingmontecarlo_tpu_torch.engines import classical as ce
    from pyisingmontecarlo_tpu_torch.graph import compile_graph
    from pyisingmontecarlo_tpu_torch.rng import key_tensor

    cg = compile_graph(edges)
    kd = _keys(R, seed)
    s0 = ce.random_states(kd, cg.nvars)
    beta = np.linspace(0.3, 1.4, T).astype(np.float32)
    out = {}
    for d in ("cpu", dev):
        ga = ce.device_graph_sorted(cg, dense=dense, device=d)
        w = None
        if iw == "per class":
            w = ce.importance_weights(cg, d)
        elif iw == "per replica":
            w = tuple(torch.where(torch.arange(R, device=d)[:, None] % 2 == 0, x[None], 1.0)
                      for x in ce.importance_weights(cg, d))
        h = torch.full((cg.nvars,), bias, dtype=torch.float32, device=d)
        fn = ce.run_steps_energies if energies else ce.run_steps
        out[str(d)] = [x.cpu() for x in fn(ga, h, s0.to(d), key_tensor(kd, d), beta, iw=w, **moves)]
    a, b = out["cpu"], out[str(dev)]
    diff = int((a[0] != b[0]).sum()) + int((a[1] != b[1]).sum())
    return diff, (torch.equal(a[2], b[2]) if energies else None), ga.A_hi is not None


def _ties(ga, bias, st, move, beta):
    """Sites whose decision in ``move`` was a tie on the CPU state ``st``: the
    uniform within 2 ulp of its acceptance probability recomputed in f64."""
    from pyisingmontecarlo_tpu_torch.engines import classical as ce

    kind = move[0]
    n, R = st.shape
    s64 = st.double()
    A = ga.A_hi.double() + (0 if ga.A_lo is None else ga.A_lo.double())
    h = bias.double()
    mask = torch.zeros((n, R), dtype=torch.bool)

    def close(u, p):
        return (u.double() - p).abs() <= 2 * torch.from_numpy(np.spacing(p.float().numpy()).astype(np.float64))

    if kind == "spin":
        lo, hi = ce._color_bounds(ga)[move[1]:move[1] + 2]
        dE = -2 * s64[lo:hi] * (A[lo:hi] @ s64 + h[lo:hi, None])
        mask[lo:hi] = close(ce._uniform_lanes(move[2], (hi - lo,)), torch.sigmoid(-beta * dE))
    elif kind == "edge":
        a, b, j = ga.e_a[move[1]], ga.e_b[move[1]], ga.e_j[move[1]].double()
        B = A @ s64
        sa, sb = s64[a], s64[b]
        dE = -2 * sa * (B[a] + h[a, None]) - 2 * sb * (B[b] + h[b, None]) + 4 * j[:, None] * sa * sb
        t = close(ce._uniform_lanes(move[2], (a.shape[0],)), torch.sigmoid(-beta * dE))
        mask[a] |= t
        mask[b] |= t
    else:
        f, closed, u = ce._worm_walk(ga, move[1], move[2], move[3], n, R)
        cut = (f[ga.edge_a] ^ f[ga.edge_b]).double()
        ebond = ga.edge_j.double()[:, None] * s64[ga.edge_a] * s64[ga.edge_b]
        dE = -2 * (ebond * cut).sum(0) - 2 * (h[:, None] * s64 * f).sum(0)
        t = closed & close(u, torch.exp(-beta * dE))
        mask |= f & t[None, :]
    return mask


def full_width_step(dev):
    """One default time step of the triangular annealing at full width
    (48^2, R = 100, beta 1.5), move by move on the card and on the CPU from
    the same state; every differing spin must be a tie of its move. Returns
    (differing spins, ties among them)."""
    from pyisingmontecarlo_tpu_torch.engines import classical as ce
    from pyisingmontecarlo_tpu_torch.graph import compile_graph
    from pyisingmontecarlo_tpu_torch.models import triangular_edges
    from pyisingmontecarlo_tpu_torch.rng import key_tensor, threefry_chain

    cg = compile_graph(triangular_edges(TRI_L, j=1.0))
    gc, gg = ce.device_graph_sorted(cg, device="cpu"), ce.device_graph_sorted(cg, device=dev)
    kd = _keys(TRI_R, 9)
    st, hc = ce._to_internal(gc, ce.random_states(kd, cg.nvars), torch.zeros(cg.nvars))
    hg = hc.to(dev)
    kinds = ce.step_plan(gc, 1, 1, 1, False)
    seeds, v0, _ = threefry_chain(key_tensor(kd, "cpu"), kinds, 1, cg.nvars)
    beta, wlen = 1.5, ce.DEFAULT_WLEN
    moves = [("spin", c, seeds[0, c]) for c in range(len(gc.c_sites))]
    moves += [("edge", c, seeds[0, len(moves) + c]) for c in range(len(gc.e_a))]
    moves += [("worm", seeds[0, len(moves)], v0[0, 0], wlen)]
    differ = ties = 0
    with ce.exact_f32_matmul():
        for move in moves:
            x, y = st.clone(), st.to(dev)
            if move[0] == "spin":
                x = ce._spin_color_update(gc, hc, x, move[2], beta, move[1], False)
                y = ce._spin_color_update(gg, hg, y, move[2].to(dev), beta, move[1], False)
            elif move[0] == "edge":
                x = ce._edge_color_update(gc, hc, x, move[2], beta, move[1], False)
                y = ce._edge_color_update(gg, hg, y, move[2].to(dev), beta, move[1], False)
            else:
                x = ce._worm_update(gc, hc, x, move[1], move[2], beta, wlen, False)
                y = ce._worm_update(gg, hg, y, move[1].to(dev), move[2].to(dev), beta, wlen, False)
            d = x != y.cpu()
            if d.any():
                tie = _ties(gc, hc, st, move, beta)
                check(bool((d <= tie).all()), f"full-width step: {int((d & ~tie).sum())} spins differ in "
                                              f"{move[0]} {move[1] if move[0] != 'worm' else ''} with no tie")
                differ += int(d.sum())
                ties += int((d & tie).sum())
            st = y.cpu()
    return differ, ties


def phase_compare_classical(dev):
    """The graph engine on the card against the port on the CPU, each family
    at a small shape (integer or dyadic couplings and fields: bit for bit),
    then one default step of the main path at full width (ties only)."""
    from pyisingmontecarlo_tpu_torch.models import triangular_edges

    tri = triangular_edges(6, j=1.0)
    dyadic = [((a, b), j * (1 + 2**-10)) for (a, b), j in triangular_edges(5, j=1.0)]
    spin = dict(nspin_sweeps=1, nedge_sweeps=0, nworms=0, only_basic=True, heatbath=False, wlen=1)
    edge = dict(nspin_sweeps=0, nedge_sweeps=1, nworms=0, only_basic=False, heatbath=False, wlen=1)
    worm = dict(nspin_sweeps=0, nedge_sweeps=0, nworms=2, only_basic=False, heatbath=False, wlen=16)
    sw = dict(nspin_sweeps=0, nedge_sweeps=0, nworms=0, only_basic=False, heatbath=False, wlen=1, nclusters=1)
    full = dict(nspin_sweeps=1, nedge_sweeps=1, nworms=1, only_basic=False, heatbath=False, wlen=32)
    cases = (
        ("spin, dense int", tri, spin, {}),
        ("spin, dense hi+lo (J = 1 + 2^-10)", dyadic, spin, {}),
        ("spin, ELL", glass_edges(64), spin, dict(dense=False)),
        ("spin, heat-bath flag, ELL, field 0.25", tri, dict(spin, heatbath=True), dict(dense=False, bias=0.25)),
        ("edge", tri, edge, {}),
        ("edge, iw [Ec]", [((a, b), j * (1 + (a % 3))) for (a, b), j in tri], edge, dict(iw="per class")),
        ("edge, iw [R, Ec]", [((a, b), j * (1 + (a % 3))) for (a, b), j in tri], edge, dict(iw="per replica")),
        ("edge, ELL", glass_edges(64), edge, dict(dense=False)),
        ("worm, field 0.25", tri, worm, dict(bias=0.25)),
        ("worm, heat-bath", glass_edges(64), dict(worm, heatbath=True), {}),
        ("SW, field 0.25", tri, sw, dict(bias=0.25)),
        ("SW, ELL, field -0.5", glass_edges(64), sw, dict(dense=False, bias=-0.5)),
        ("annealing energies, default moves", tri, full, dict(energies=True)),
    )
    for name, edges, moves, kw in cases:
        diff, es_equal, dense = _engine_case(dev, edges, 16, 12, moves, **kw)
        check(diff == 0 and es_equal in (None, True), f"compare-classical {name}: {diff} differing spins and keys, "
                                                       f"energies equal {es_equal}")
        print(f"compare-classical: {name}: 16 replicas, 12 steps, {'dense' if dense else 'ELL'} path: card == CPU "
              f"bit for bit (states, keys{', energies' if es_equal else ''})", flush=True)
    differ, ties = full_width_step(dev)
    print(f"compare-classical: one default step of the main path at full width ({TRI_L}^2, R={TRI_R}, beta 1.5, "
          f"move by move): {differ} spins differ, {ties} of them at ties", flush=True)


def _profile_call(fn, steps):
    """(torch operations a step, device operations a step, idle share %, device
    ms by kernel) over one call of ``fn`` (``steps`` steps) under torch.profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.events()
    ops = sum(1 for e in evs if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("aten::")
              and e.cpu_parent is None)
    dev_t = _device_times(prof, ("threefry_chain", "gemm", "sgemm"), everything=True)
    if dev_t is None:
        return ops / steps, None, None, None
    per, busy, span = dev_t
    return (ops / steps, sum(len(v) for v in per.values()) / steps, 100 * (1 - busy / span),
            {k: float(np.sum(v)) / 1e3 for k, v in per.items()})


def phase_main_classical(dev, smi):
    """The annealing of BASELINE.json config 2 through Lattice, depth cut to
    200 steps: steps/s, site-steps/s, the host's set-up, the key chain's
    launch and time, torch operations and launches a step and the idle share;
    checks the energies and the schedule. Returns the chain's launches."""
    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch.engines import classical as ce
    from pyisingmontecarlo_tpu_torch.models import triangular_edges
    from pyisingmontecarlo_tpu_torch.rng import threefry_chain_reference

    n, T, R = TRI_L**2, TRI_T, TRI_R
    lat = Lattice(triangular_edges(TRI_L, j=1.0), seed_gen=TRI_SEED, device=dev)
    check(lat._torus is None, "the triangular lattice took the torus path")
    sched = [(0, 0.1), (T, 3.0)]
    t0 = time.perf_counter()
    ga = lat._graph_arrays()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    reset_counts()
    t0 = time.perf_counter()
    es, st = lat.run_monte_carlo_annealing_and_get_energies(sched, T, R)
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(counts == counts_only(keychain=1), f"launch counts {counts}, want one threefry_chain launch only")
    check(es.shape == (R, T) and st.shape == (R, n) and np.isfinite(es).all(), f"shapes {es.shape} {st.shape}")
    s = torch.from_numpy(np.where(st, 1, -1).astype(np.int8)).to(dev)
    again = ce.energy(ga, torch.zeros(n, device=dev), s).cpu().numpy().astype(np.float64)
    check(np.array_equal(es[:, -1], again), "the last energy column != energy(states)")
    first, last = es[:, : T // 10].mean() / n, es[:, -T // 10:].mean() / n
    check(last < first - 0.3 and last < -0.8, f"<E>/site {first} at the start, {last} at the end")
    print(f"main-classical: Lattice(triangular_edges({TRI_L}, j=1.0), seed_gen={TRI_SEED})."
          f"run_monte_carlo_annealing_and_get_energies({sched}, {T}, {R}) (depth cut from {TRI_T_FULL}), on {smi}: "
          f"dense int path ({len(ga.c_sites)} site colors, {len(ga.e_a)} strong edge classes, 1 worm a step), "
          f"{counts['keychain']} threefry_chain launch; {wall:.3f} s host wall ({wall / T * 1e3:.3f} ms a step) = "
          f"{T / wall:.2f} steps/s = "
          f"{n * R * T / wall:.4g} site-steps/s; graph set-up {setup_s * 1e3:.1f} ms (colorings, ELL, dense planes, "
          f"paid once a Lattice); <E>/site {first:.4f} over the first {T // 10} steps, {last:.4f} over the last",
          flush=True)
    steps = 20
    lat.run_monte_carlo_annealing_and_get_energies(sched, steps, R)  # warm-up at the profiled length
    t0 = time.perf_counter()
    lat.run_monte_carlo_annealing_and_get_energies(sched, steps, R)
    short = time.perf_counter() - t0
    ops, launches, idle, per = _profile_call(lambda: lat.run_monte_carlo_annealing_and_get_energies(sched, steps, R),
                                             steps)
    dev_line = ("device time not measured (the profiler recorded none)" if per is None else
                f"{launches:.1f} device operations a step, device idle {idle:.2f}% of the call; device ms by kernel "
                + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per.items())))
    t0 = time.perf_counter()
    threefry_chain_reference(_keys(R, 1), tri_plan(), steps, n)
    plain_chain = (time.perf_counter() - t0) * 1e3
    print(f"main-classical: a {steps}-step call on {smi}: {short:.3f} s host wall ({steps / short:.2f} steps/s, "
          f"{short / steps * 1e3:.3f} ms a step); under torch.profiler {ops:.1f} torch operations a step; {dev_line}; "
          f"the numpy chain of these {steps} steps {plain_chain:.3f} ms", flush=True)
    return counts["keychain"]


def phase_main_classicising(dev, smi):
    """ClassicIsing on the glass of benches/bench_classical_graph.py: each
    move family's ms a step (the slope between 10- and 40-step calls, the
    best of two each), and get_energies against the energies a sampling run
    returned. Returns {size/family: ms a step}."""
    from pyisingmontecarlo_tpu_torch import ClassicIsing

    out = {}
    for n in GLASS_NS:
        ci = ClassicIsing(glass_edges(n), num_experiments=GLASS_R, seed=3, device=dev)
        E = ci.cg.nedges
        fams = {"spin": dict(nspinupdates=n, nedgeupdates=0, nwormupdates=0)}
        if n <= 8192:
            fams.update({"spin+edge": dict(nspinupdates=n, nedgeupdates=E, nwormupdates=0),
                         "spin+worm": dict(nspinupdates=n, nedgeupdates=0, nwormupdates=1),
                         "default": {}, "default+sw": {}})
        reset_counts()
        for fam, kw in fams.items():
            ci.set_enable_cluster_updates(fam == "default+sw")
            ci.run_monte_carlo(GLASS_BETA, 2, **kw)  # warm-up
            wall = {}
            for T in (10, 40, 10, 40):
                t0 = time.perf_counter()
                ci.run_monte_carlo(GLASS_BETA, T, **kw)
                torch.cuda.synchronize()
                wall.setdefault(T, []).append(time.perf_counter() - t0)
            out[f"{n}/{fam}"] = (min(wall[40]) - min(wall[10])) / 30 * 1e3
        counts = read_counts()
        check(counts["keychain"] > 0 and counts["sq2d"] == 0, f"launch counts {counts}")
        ci.set_enable_cluster_updates(False)
        es, _ = ci.run_monte_carlo_sampling(GLASS_BETA, 4, sampling_freq=2, **fams["spin"])
        check(np.array_equal(es[:, -1], ci.get_energies()), "get_energies != the sampling run's last energies")
        e = ci.get_energies().mean() / n
        check(-2.0 <= e < -0.9, f"<E>/site {e} on the glass at beta {GLASS_BETA}")
        path = "dense" if ci._graph_arrays().A_hi is not None else "ELL"
        print(f"main-classicising: ClassicIsing on the 4-regular +-J glass, n={n} ({path} path), R={GLASS_R}, "
              f"beta={GLASS_BETA}, on {smi}: " + ", ".join(f"{fam} {out[f'{n}/{fam}']:.3f}" for fam in fams)
              + f" ms a step; {counts['keychain']} threefry_chain launches; get_energies == the run's last "
              f"energies; <E>/site {e:.4f}", flush=True)
    return out


def exact_classical(edges, h, beta):
    """<E> of H = sum J s_a s_b + h sum s by enumeration of every state."""
    import itertools

    n = max(max(a, b) for (a, b), _ in edges) + 1
    s = np.array(list(itertools.product((-1, 1), repeat=n)), np.float64)
    e = sum(j * s[:, a] * s[:, b] for (a, b), j in edges) + h * s.sum(1)
    w = np.exp(-beta * (e - e.min()))
    return float((w * e).sum() / w.sum())


def phase_physics_classical(dev):
    """<E> on the card against exact enumeration, within 4 se: a frustrated
    10-site graph with a field, through Lattice (default moves, then with
    cluster updates) and through ClassicIsing."""
    from pyisingmontecarlo_tpu_torch import ClassicIsing, Lattice

    rng = np.random.default_rng(12)
    edges = [((i, (i + 1) % 10), 1.0) for i in range(10)] + [((i, (i + 3) % 10), float(rng.choice([-1.0, 0.5])))
                                                             for i in range(0, 10, 2)]
    h, beta = 0.25, 0.8
    exact = exact_classical(edges, h, beta)
    out = []
    for name, cluster in (("Lattice", False), ("Lattice, clusters", True)):
        lat = Lattice(edges, seed_gen=5, device=dev)
        lat.set_global_bias(h)
        lat.set_enable_cluster_updates(cluster)
        es, _ = lat.run_monte_carlo_sampling(beta, 100, 256, thermalization_time=50, sampling_freq=4)
        m, se = es.mean(), es.mean(1).std(ddof=1) / np.sqrt(es.shape[0])
        check(abs(m - exact) < 4 * se, f"physics-classical {name}: <E> {m} vs exact {exact}, se {se}")
        out.append(f"{name} {m:.4f} (se {se:.4f})")
    ci = ClassicIsing(edges, longitudinal=h, num_experiments=256, seed=6, device=dev)
    es, _ = ci.run_monte_carlo_sampling(beta, 100, thermalization_time=50, sampling_freq=4)
    m, se = es.mean(), es.mean(1).std(ddof=1) / np.sqrt(es.shape[0])
    check(abs(m - exact) < 4 * se, f"physics-classical ClassicIsing: <E> {m} vs exact {exact}, se {se}")
    out.append(f"ClassicIsing {m:.4f} (se {se:.4f})")
    print(f"physics-classical: 10-site frustrated graph, h={h}, beta={beta}: exact <E> {exact:.4f}; "
          + "; ".join(out), flush=True)


# the QmcIsing main path: QmcIsing on the 4-regular +-J glass of benches/bench_classical_graph.py at
# n = 4096, 64 experiments, Gamma = 1, h = 0, beta = 2 (L_tau = 40): run_qmc(2.0, 100), then
# run_sampling(2.0, 200, sampling_freq=10), on the generic worldline engine
QMC_N, QMC_R, QMC_BETA, QMC_GAMMA, QMC_SEED = 4096, 64, 2.0, 1.0, 17
QMC_T, QMC_SAMPLE_T, QMC_FREQ = 100, 200, 10
# card vs CPU energy sums: both accumulate the same f32 per-sweep estimators in a compensated pair, with
# the lattice sums reduced in another order on each device
QMC_E_RTOL = 2e-6


def _worldline_case(dev, edges, R, L, beta, gamma, h, seed):
    """One graph's generic-engine inputs on the CPU and on the card: graph
    arrays, the same f32 parameters, a random worldline state (half the lines
    straight in tau) and key data."""
    from pyisingmontecarlo_tpu_torch.engines import classical as ce
    from pyisingmontecarlo_tpu_torch.engines import worldline as wl
    from pyisingmontecarlo_tpu_torch.graph import compile_graph

    cg = compile_graph(edges)
    r = np.random.default_rng(seed)
    s = r.integers(0, 2, (R, cg.nvars, L)).astype(np.int8) * 2 - 1
    s[:, : cg.nvars // 2] = s[:, : cg.nvars // 2, :1]
    pc = wl.make_params(np.full(R, beta), gamma, h, L)
    return cg, {d: (ce.device_graph(cg, d), wl.params_from_arrays([x.numpy() for x in pc[:5]], d))
                for d in ("cpu", dev)}, s, _keys(R, seed)


def _generic_calls(ga, p, s, keys, nedges):
    """Every generic run function in turn, each from the last one's state and keys:
    {name: tensors on the CPU} and the energies (f64)."""
    from pyisingmontecarlo_tpu_torch.engines import worldline as wl
    from pyisingmontecarlo_tpu_torch.utils.accum import kfinal

    out, es = {}, {}
    s, keys, e = wl.run_sweeps(ga, p, s, keys, 6, True, True)
    out["run_sweeps"], es["run_sweeps"] = [s, keys], kfinal(e)
    s, keys, e, smp = wl.run_sweeps_sample(ga, p, s, keys, 5, 2, True, True)
    out["run_sweeps_sample"], es["run_sweeps_sample"] = [s, keys, smp], kfinal(e)
    s, keys = wl.run_diagonal_sweeps(ga, p, s, keys, 3)
    out["run_diagonal_sweeps"] = [s, keys]
    sizes = []
    for _ in range(3):
        s, keys, z = wl.run_single_cluster(ga, p, s, keys)
        sizes.append(z)
    out["run_single_cluster"] = [s, keys, torch.stack(sizes)]
    s, keys, ratios = wl.run_rvb_sweeps(ga, p, s, keys, 3, nedges + 5)
    out["run_rvb_sweeps"] = [s, keys, ratios]
    return {k: [x.cpu() for x in v] for k, v in out.items()}, es


def _phase_ties(ga, p, st, seeds, phase):
    """Spins of the CPU state ``st`` whose decision in one generic phase is a
    tie: it changes when the site phase's acceptance probability, or the
    cluster phase's log-uniform, moves by 4 ulp either way."""
    from pyisingmontecarlo_tpu_torch.engines import classical as ce
    from pyisingmontecarlo_tpu_torch.engines import worldline as wl
    from pyisingmontecarlo_tpu_torch.ops.wl import fk_flips

    def nudge(x, toward, k=4):
        for _ in range(k):
            x = torch.nextafter(x, torch.full_like(x, toward))
        return x

    kind, c = phase[0], phase[1]
    sites = ga.c_sites[c]
    R, _, L = st.shape
    si = st.index_select(1, sites)
    B = wl._spatial_field(ga.c_nbrs[c], ga.c_j[c], st)
    col = lambda x: x[:, None, None]  # noqa: E731
    if kind == "site":
        up, dn = si.roll(-1, 2).float(), si.roll(1, 2).float()
        dE = -2.0 * si.float() * (col(p.dtau) * (B + col(p.h)) - col(p.ktau) * (up + dn))
        u = ce._uniform_per_replica(seeds, (sites.shape[0], L))
        prob = torch.sigmoid(dE * -1.0)
        tie = (u < nudge(prob, 0.0)) != (u < nudge(prob, 1.0))
        tie &= (torch.arange(L) % 2) == phase[2]
    else:
        u = ce._uniform_per_replica(seeds, (sites.shape[0], L, 2))
        active = ((si == si.roll(-1, 2)) & (u[..., 0] < col(p.pbond))).int()
        dE = -2.0 * si.float() * col(p.dtau) * (B + col(p.h))
        log_u = torch.log(u[..., 1])
        tie = fk_flips(active, dE, nudge(log_u, -np.inf)) != fk_flips(active, dE, nudge(log_u, np.inf))
    mask = torch.zeros(st.shape, dtype=torch.bool)
    mask[:, sites] = tie
    return mask


def qmc_full_width_sweep(dev):
    """One generic sweep of the main path's glass at full width (n = 4096,
    R = 64, L_tau = 40), phase by phase on the card and on the CPU from the
    same state (after 5 sweeps on the card from a random classical start);
    every differing spin must be a tie of its phase. Returns (differing
    spins, ties among them, decisions)."""
    from pyisingmontecarlo_tpu_torch.engines import worldline as wl
    from pyisingmontecarlo_tpu_torch.rng import KEY_PLAIN, key_tensor, random_states, threefry_chain

    cg, arrays, _, kd = _worldline_case(dev, glass_edges(QMC_N), QMC_R, WL_LTAU, QMC_BETA, QMC_GAMMA, 0.0, 29)
    (gc, pc), (gg, pg) = arrays["cpu"], arrays[dev]
    s0 = torch.from_numpy(random_states(kd, cg.nvars))[:, :, None].expand(-1, -1, WL_LTAU).contiguous()
    st, keys, _ = wl.run_sweeps(gg, pg, s0.to(dev), key_tensor(kd, dev), 5)
    st = st.cpu()
    C = len(gc.c_sites)
    phases = [("site", c, parity) for c in range(C) for parity in (0, 1)] + [("cluster", c) for c in range(C)]
    seeds, _, _ = threefry_chain(keys.cpu(), [KEY_PLAIN] * len(phases), 1, cg.nvars)
    differ = ties = 0
    for col, phase in enumerate(phases):
        x, y, sd = st.clone(), st.to(dev), seeds[0, col]
        if phase[0] == "site":
            x = wl._site_color_update(gc, pc, x, sd, phase[1], phase[2])
            y = wl._site_color_update(gg, pg, y, sd.to(dev), phase[1], phase[2])
        else:
            x = wl._time_cluster_update(gc, pc, x, sd, phase[1])
            y = wl._time_cluster_update(gg, pg, y, sd.to(dev), phase[1])
        d = x != y.cpu()
        if d.any():
            tie = _phase_ties(gc, pc, st, sd, phase)
            check(bool((d <= tie).all()), f"full-width sweep: {int((d & ~tie).sum())} spins differ in {phase} "
                                          f"with no tie")
            differ += int(d.sum())
            ties += int((d & tie).sum())
        st = y.cpu()
    return differ, ties, 2 * QMC_R * QMC_N * WL_LTAU


def phase_compare_qmc_generic(dev):
    """The generic worldline engine on the card against the same engine on
    the CPU: every run function on a small glass and a triangular patch, RVB on,
    bit for bit in states, keys, samples, cluster sizes and RVB ratios, the
    energies within QMC_E_RTOL; one full-width sweep of the main path's glass
    (ties only); the key chain's all-plain plan of the main path against its
    numpy version, bit for bit. Returns the largest |difference| of the chain."""
    from pyisingmontecarlo_tpu_torch.engines import worldline as wl
    from pyisingmontecarlo_tpu_torch.models import triangular_edges
    from pyisingmontecarlo_tpu_torch.rng import KEY_PLAIN, key_tensor, threefry_chain, threefry_chain_reference

    cases = (("glass n=64, h=0.3, L_tau=40", glass_edges(64), 16, 40, 2.0, 1.0, 0.3),
             ("triangular 6x6, h=0.25, L_tau=24", triangular_edges(6, j=1.0), 16, 24, 1.5, 0.7, 0.25))
    for name, edges, R, L, beta, gamma, h in cases:
        cg, arrays, s, kd = _worldline_case(dev, edges, R, L, beta, gamma, h, 31)
        res = {d: _generic_calls(*arrays[d], torch.from_numpy(s).to(d), key_tensor(kd, d), cg.nedges)
               for d in ("cpu", dev)}
        (want, we), (got, ge) = res["cpu"], res[dev]
        for k in want:
            diff = sum(int((a != b).sum()) for a, b in zip(want[k], got[k]))
            check(diff == 0, f"compare-qmc-generic {name}: {k}: {diff} differing values, card vs CPU")
        for k in we:
            err = float(np.abs(ge[k] - we[k]).max() / np.abs(we[k]).max())
            check(err <= QMC_E_RTOL, f"compare-qmc-generic {name}: {k} energies differ by {err:.3g} relative")
        sizes, ratios = got["run_single_cluster"][2], got["run_rvb_sweeps"][2]
        check(bool(((sizes >= 1) & (sizes <= L)).all() and ((ratios >= 0) & (ratios <= 1)).all()),
              "cluster sizes or RVB ratios out of range")
        print(f"compare-qmc-generic: {name}, R={R}, RVB on: run_sweeps, run_sweeps_sample, run_diagonal_sweeps, "
              f"run_single_cluster x3, run_rvb_sweeps: card == CPU bit for bit (states, keys, samples, sizes, "
              f"ratios); energies within {QMC_E_RTOL:g} relative", flush=True)
    t0 = time.perf_counter()
    differ, ties, decisions = qmc_full_width_sweep(dev)
    print(f"compare-qmc-generic: one sweep of the main path's glass at full width (n={QMC_N}, R={QMC_R}, "
          f"L_tau={WL_LTAU}, phase by phase, {decisions} site and bond decisions): {differ} spins differ, {ties} of "
          f"them at f32 ties ({time.perf_counter() - t0:.1f} s)", flush=True)
    from pyisingmontecarlo_tpu_torch.engines import classical as ce
    from pyisingmontecarlo_tpu_torch.graph import compile_graph

    kinds = [KEY_PLAIN] * wl.sweep_slots(ce.device_graph(compile_graph(glass_edges(QMC_N))), True, False)
    kd = _keys(QMC_R, 37)
    t0 = time.perf_counter()
    want = threefry_chain_reference(kd, kinds, QMC_T, QMC_N)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = [g.cpu().numpy() for g in threefry_chain(key_tensor(kd, dev), kinds, QMC_T, QMC_N)]
    want = [want[0], want[1], key_tensor(want[2], "cpu").numpy()]
    err = max(int(np.abs(g.astype(np.int64) - w.astype(np.int64)).max()) if g.size else 0 for g, w in zip(got, want))
    check(err == 0 and all(g.shape == w.shape for g, w in zip(got, want)),
          f"compare-qmc-generic: threefry_chain of the glass plan != its numpy version (max |diff| {err})")
    print(f"compare-qmc-generic: threefry_chain, the main path's all-plain plan ({len(kinds)} slots a sweep x "
          f"{QMC_T} sweeps x R={QMC_R}) == its numpy version bit for bit (numpy {plain_ms:.3f} ms)", flush=True)
    return err


def phase_main_qmcising(dev, smi):
    """The QmcIsing main path: run_qmc(2.0, 100), then run_sampling(2.0, 200,
    sampling_freq=10), on the glass at full width through the user's entry
    points (generic route, one threefry_chain launch a call); host wall and
    CUDA-event times, sweeps/s and spin updates/ns; then a 20-sweep call under
    torch.profiler: torch and device operations a sweep, idle share, device
    ms by kernel. Returns the threefry_chain launches and the sweeps/s."""
    from pyisingmontecarlo_tpu_torch import QmcIsing

    n, R, L = QMC_N, QMC_R, WL_LTAU
    t0 = time.perf_counter()
    q = QmcIsing(glass_edges(n), QMC_GAMMA, 0.0, num_experiments=R, seed=QMC_SEED, device=dev)
    w = q._ensure(QMC_BETA)
    ga = w.ga
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check(w.L == L and not w.on_kernel(), f"L_tau {w.L}, kernel route {w.on_kernel()}")
    reset_counts()
    out = {}
    for name, fn, T in (("run_qmc", lambda: q.run_qmc(QMC_BETA, QMC_T), QMC_T),
                        ("run_sampling", lambda: q.run_sampling(QMC_BETA, QMC_SAMPLE_T, sampling_freq=QMC_FREQ),
                         QMC_SAMPLE_T)):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e0.record()
        res = fn()
        e1.record()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0, e0.elapsed_time(e1), T, res)
    counts = read_counts()
    check(counts == counts_only(keychain=2), f"launch counts {counts}, want two threefry_chain launches only")
    es, ss = out["run_sampling"][3]
    check(es.shape == (R,) and es.dtype == np.float64 and np.isfinite(es).all(), f"energies {es.shape} {es.dtype}")
    check(ss.shape == (R, QMC_SAMPLE_T // QMC_FREQ, n) and ss.dtype == np.bool_, f"samples {ss.shape} {ss.dtype}")
    check(np.array_equal(ss[:, -1], w.states_bool()), "the last sample != slice 0 of the final state")
    e = es.mean() / n
    # 300 sweeps from a random start at Gamma = 1, beta = 2: a 4-regular +-J glass's classical ground state
    # is near -1.3 a site and the transverse term lowers the energy further; a random state is near 0
    check(-2.5 < e < -0.8, f"e/site {e} outside (-2.5, -0.8)")
    lines = []
    for name, (wall, ev_ms, T, _) in out.items():
        lines.append(f"{name}: {wall:.3f} s host wall, {ev_ms:.3f} ms between CUDA events, {T / wall:.2f} sweeps/s, "
                     f"{R * n * L * T / wall / 1e9:.4f} spin updates/ns")
    print(f"main-qmcising: QmcIsing(glass_edges({n}), {QMC_GAMMA}, 0.0, {R}, seed={QMC_SEED}) on {smi}: generic route "
          f"({len(ga.c_sites)} site colors: {3 * len(ga.c_sites)} phases a sweep), L_tau={L}, set-up "
          f"{setup_s * 1e3:.1f} ms; " + "; ".join(lines) + f"; {counts['keychain']} threefry_chain launches; "
          f"e/site {e:.5f}", flush=True)
    steps = 20
    q.run_qmc(QMC_BETA, steps)  # warm-up at the profiled length
    ops, launches, idle, per = _profile_call(lambda: q.run_qmc(QMC_BETA, steps), steps)
    dev_line = ("device time not measured (the profiler recorded none)" if per is None else
                f"{launches:.1f} device operations a sweep, device idle {idle:.2f}% of the call; device ms by kernel "
                + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per.items())))
    print(f"main-qmcising: a {steps}-sweep run_qmc under torch.profiler on {smi}: {ops:.1f} torch operations a "
          f"sweep; {dev_line}", flush=True)
    wall, _, T, _ = out["run_qmc"]
    return counts["keychain"], T / wall


def phase_main_qmcising_lattice(dev):
    """QmcIsing on the worldline kernels' lattices: run_qmc(2.0, 200) on the
    256^2 torus (R = 8; tiled, one launch a sweep) and run_sampling(2.0, 2000,
    wait 500, freq 10) on the 256-chain (R = 64; resident, one launch for the
    wait and one for the sampled sweeps), against the exact free-fermion
    energy. Returns (tiled launches, resident launches)."""
    from pyisingmontecarlo_tpu_torch import QmcIsing
    from pyisingmontecarlo_tpu_torch.graph import grid_2d_edges

    (_, nvars, R), side, T = TORUS, TORUS[0][1], 200
    q = QmcIsing(grid_2d_edges(side, side, -1.0), WL_GAMMA, 0.0, num_experiments=R, seed=3, device=dev)
    reset_counts()
    t0 = time.perf_counter()
    q.run_qmc(WL_BETA, T)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    tiled = read_counts()
    check(tiled == counts_only(wl_tiled=T), f"launch counts {tiled}, want wl_tiled {T} only")
    m = float(np.mean([abs(np.where(q.get_graph_itime(g), 1.0, -1.0).mean()) for g in range(R)]))
    print(f"main-qmcising-lattice: QmcIsing on the {side}^2 torus, R={R}, run_qmc({WL_BETA}, {T}): "
          f"{tiled['wl_tiled']} wl_tiled launches, 0 others, {dt:.3f} s host wall, <|m|> {m:.4f}", flush=True)
    (_, n, R), wait, T, freq = CHAIN, 500, 2000, 10
    q = QmcIsing([((i, (i + 1) % n), -1.0) for i in range(n)], WL_GAMMA, 0.0, num_experiments=R, seed=4,
                 device=dev)
    reset_counts()
    t0 = time.perf_counter()
    es, ss = q.run_sampling(WL_BETA, T, sampling_wait_buffer=wait, sampling_freq=freq)
    dt = time.perf_counter() - t0
    res = read_counts()
    check(res == counts_only(wl_resident=2), f"launch counts {res}, want wl_resident 2 only")
    check(ss.shape == (R, T // freq, n) and np.isfinite(es).all(), f"samples {ss.shape}")
    e, se = es.mean() / n, es.std(ddof=1) / np.sqrt(R) / n
    exact = chain_energy(n, WL_BETA, WL_GAMMA)
    check(abs(e - exact) < 4 * se + 0.03, f"e/site {e} vs exact {exact} (se {se})")
    print(f"main-qmcising-lattice: QmcIsing on the {n}-chain, R={R}, run_sampling({WL_BETA}, {T}, wait={wait}, "
          f"freq={freq}): {res['wl_resident']} wl_resident launches, 0 others, {dt:.3f} s host wall, "
          f"e/site={e:.6f} (exact {exact:.6f}, se {se:.6f})", flush=True)
    return tiled["wl_tiled"], res["wl_resident"]


def phase_physics_qmcising(dev):
    """<E> on the card within 4 se + 0.03 of dense diagonalization:
    QmcIsing on an 8-site non-uniform +-J graph with a field, Lattice on a
    3 x 3 open triangular patch with RVB on, and each rung of a 3-rung
    LatticeTempering glass ladder off the ladder kernel's gate; run_cluster's
    sizes in [1, L_tau] and run_rvb's ratios in [0, 1]."""
    from pyisingmontecarlo_tpu_torch import Lattice, LatticeTempering, QmcIsing
    from pyisingmontecarlo_tpu_torch.models import triangular_edges

    out = []

    def near(name, es, exact):
        m, se = es.mean(), es.std(ddof=1) / np.sqrt(len(es))
        check(abs(m - exact) < 4 * se + 0.03, f"physics-qmcising {name}: <E> {m} vs dense {exact} (se {se})")
        out.append(f"{name} {m:.4f} (dense {exact:.4f}, se {se:.4f})")

    g8 = [((0, 1), -1.0), ((1, 2), 1.0), ((2, 3), -1.0), ((3, 0), -1.0), ((4, 5), 1.0), ((5, 6), -1.0),
          ((6, 7), -1.0), ((7, 4), 1.0), ((0, 4), -0.5), ((2, 6), 1.0)]
    q = QmcIsing(g8, 0.8, 0.3, num_experiments=96, seed=5, do_rvb_updates=True, device=dev)
    es, _ = q.run_sampling(1.5, 200, sampling_wait_buffer=150)
    near("QmcIsing 8-site +-J, h=0.3, Gamma=0.8, beta=1.5, RVB", es, dense_tfim_energy(g8, 0.3, 0.8, 1.5, 8))
    sizes, ratios = q.run_cluster(), q.run_rvb(5)
    check(sizes.shape == (96,) and ((sizes >= 1) & (sizes <= q._w.L)).all(), f"cluster sizes {sizes.min()}..")
    check(ratios.shape == (96, 5) and ((ratios >= 0) & (ratios <= 1)).all(), "RVB ratios out of [0, 1]")
    tri = triangular_edges(3, j=1.0, periodic=False)
    lat = Lattice(tri, seed_gen=6, device=dev)
    lat.set_transverse_field(1.0)
    lat.set_enable_rvb_update(True)
    es, _ = lat.run_quantum_monte_carlo_sampling(1.0, 200, 96, sampling_wait_buffer=150)
    near("Lattice 3x3 triangular, RVB, Gamma=1, beta=1", es, dense_tfim_energy(tri, 0.0, 1.0, 1.0, 9))
    glass = glass_edges(8, seed=3)
    betas = [0.8, 1.1, 1.4]
    lt = LatticeTempering(glass, seed=7, device=dev)
    for _ in range(32):
        for b in betas:
            lt.add_graph(1.0, 0.25, b)
    check("ga" in lt._materialize(), "the glass ladder took the ladder kernel")
    lt.qmc_timesteps(150)
    _, es = lt.qmc_timesteps_sample(300)
    check(lt.get_total_swaps() > 0, "no swaps")
    for k, b in enumerate(betas):
        near(f"LatticeTempering glass rung beta={b}", es[k::3], dense_tfim_energy(glass, 0.25, 1.0, b, 8))
    print("physics-qmcising: " + "; ".join(out) + f"; run_cluster sizes {sizes.min()}..{sizes.max()} of "
          f"L_tau={q._w.L}, run_rvb ratios {ratios.min():.3f}..{ratios.max():.3f}", flush=True)


# the QmcRunner main path: benches/bench_qmcrunner_hard.py's system (a ring of n = 32 with ZZ bonds J = -1, X
# fields Gamma = 1, XX bonds jx = 0.5 and ZZZ triples k3 = 0.25; R = 64, beta = 1) and benches/bench_qmcrunner.py's
# 64-site TFIM chain as generic terms (R = 64, beta = 1), each timed by the slope between two run_sampling calls
# as the benches time it, depth cut to a quarter (the benches' 200 -> 800 and 400 -> 1600 sweeps took ~270 s of
# the script's time at 6-27 sweeps/s); compare-qmcrunner forces each route on the hard family at n = 128
QR_N, QR_R, QR_BETA = 32, 64, 1.0
QR_SLOPE, QR_CHAIN_SLOPE = (50, 200), (100, 400)
QR_CROSS_N = 128
# physics-qmcrunner: XX bonds mix slowly (term kinks); at beta 0.5 a 6-ring settles within 300 sweeps
QR_PHYS = (("6-ring ZZ + X(0.7) + XX(0.5)", 6, dict(gamma=0.7, jx=0.5, k3=0.0), 0.5, 300, 200),
           ("8-ring ZZ + X(0.8) + ZZZ(0.4)", 8, dict(gamma=0.8, jx=0.0, k3=0.4), 1.0, 100, 200))
# the tolerance of tests/test_generic_gm.py on a delta: a Glauber decision whose delta differs by no more
# between the card and the CPU is a tie of f32 rounding
QR_DELTA_ATOL, QR_DELTA_RTOL = 3e-4, 1e-4


def _zz(j):
    return np.array([j * (1 if (i & 1) else -1) * (1 if (i & 2) else -1) for i in range(4)], np.float64)


def _zzz(k):
    return np.array([k * np.prod([1 if (i >> b) & 1 else -1 for b in range(3)]) for i in range(8)], np.float64)


def _xx(jx):
    m = np.zeros((4, 4))
    for a in range(4):
        m[a, a ^ 3] = -jx
    return m.reshape(-1)


def _x(gamma):
    return np.array([0.0, -gamma, -gamma, 0.0])


def hard_terms(n, gamma=1.0, jx=0.5, k3=0.25, ring=None):
    """benches/bench_qmcrunner_hard.py's terms on a ring of ``ring`` (default
    n) of the n variables, XX and ZZZ left out where jx or k3 is 0:
    [(kind, matrix, vars)]."""
    ring = n if ring is None else ring
    out = []
    for i in range(ring):
        out += [("diag", _zz(-1.0), [i, (i + 1) % ring]), ("full", _x(gamma), [i])]
        if jx:
            out.append(("full", _xx(jx), [i, (i + 1) % ring]))
        if k3:
            out.append(("diag", _zzz(k3), [i, (i + 1) % ring, (i + 2) % ring]))
    return out


def chain_terms(n, gamma=1.0):
    """benches/bench_qmcrunner.py's 64-site TFIM chain as generic terms."""
    out = []
    for i in range(n):
        out += [("diag", _zz(-1.0), [i, (i + 1) % n]), ("full", _x(gamma), [i])]
    return out


def qmc_runner(nvars, R, terms, dev, seed=0, **kw):
    from pyisingmontecarlo_tpu_torch import QmcRunner

    q = QmcRunner(nvars, R, seed=seed, device=dev, **kw)
    for kind, mat, vs in terms:
        (q.add_diagonal_interaction if kind == "diag" else q.add_interaction)(mat, vs)
    return q


class _route:
    """PMC_GENERIC_GM set to ``mode`` for the duration (None: unset)."""

    def __init__(self, mode):
        self.mode = mode

    def __enter__(self):
        import os

        self.old = os.environ.get("PMC_GENERIC_GM")
        if self.mode is None:
            os.environ.pop("PMC_GENERIC_GM", None)
        else:
            os.environ["PMC_GENERIC_GM"] = self.mode

    def __exit__(self, *exc):
        import os

        if self.old is None:
            os.environ.pop("PMC_GENERIC_GM", None)
        else:
            os.environ["PMC_GENERIC_GM"] = self.old


def qr_full_width_sweep(dev):
    """One gm sweep of the hard n = 32, R = 64 system at full width, on the
    card and on the CPU from the same state (after 5 sweeps on the card from
    a random start) and keys. The CPU's Glauber decisions are recorded, and
    the card's run replays them: each card decision is compared with the
    CPU's, every differing one must have deltas within QR_DELTA_ATOL +
    QR_DELTA_RTOL |delta| of each other (a tie), and the CPU's decision is
    kept so that the two runs stay aligned; the uniforms must be equal bit
    for bit, and so must the final planes and keys. Returns (decisions,
    ties, largest |delta difference| over all decisions with |delta| < 80)."""
    from pyisingmontecarlo_tpu_torch.engines import classical as ce
    from pyisingmontecarlo_tpu_torch.engines import generic as ge
    from pyisingmontecarlo_tpu_torch.engines import generic_gm as gg
    from pyisingmontecarlo_tpu_torch.rng import key_tensor, threefry_chain

    with _route(None):
        q = qmc_runner(QR_N, QR_R, hard_terms(QR_N), dev, seed=11)
        q.run_sampling(QR_BETA, 5)
    w = q._w
    check(w.use_gm, "the hard n = 32 system took the classic route")
    gs_c = gg.compile_gm(w.comp, QR_N, "cpu")
    kinks_c = gg.compile_gm_kinks(w.comp, gs_c, "cpu")
    plan = ge.sweep_plan(w.comp, w.ltau, False, gm=True)
    seeds, v0, keys = threefry_chain(key_tensor(w.key_data, "cpu"), plan, 1, 1)
    s = w.s.cpu()
    record, stats = [], {"decisions": 0, "ties": 0, "max_dd": 0.0}

    def rec(u, delta):
        acc = u < torch.sigmoid(delta)
        record.append((u, delta, acc))
        return acc

    def replay(u, delta):
        u_c, d_c, acc_c = record[len(stats.setdefault("seen", []))]
        stats["seen"].append(1)
        check(torch.equal(u.cpu(), u_c), "full-width gm sweep: the uniforms differ between the card and the CPU")
        d = delta.cpu()
        acc = u.cpu() < torch.sigmoid(d)
        diff = acc != acc_c
        dd = (d - d_c).abs()
        live = (d_c.abs() < 80) & (d.abs() < 80)
        stats["decisions"] += acc.numel()
        stats["max_dd"] = max(stats["max_dd"], float(dd[live].max()) if live.any() else 0.0)
        if diff.any():
            tol = QR_DELTA_ATOL + QR_DELTA_RTOL * d_c.abs()
            check(bool((dd[diff] <= tol[diff]).all()), f"full-width gm sweep: {int(diff.sum())} decisions differ, "
                                                        f"some with deltas further apart than the tolerance")
            stats["ties"] += int(diff.sum())
        return acc_c.to(u.device)

    old = gg.glauber
    try:
        gg.glauber = rec
        with ce.exact_f32_matmul():
            want = gg.sweep_gm(gs_c, kinks_c, gg.to_gm(s, w.comp.G), seeds[0], v0[0], QR_R, False)
        gg.glauber = replay
        with ce.exact_f32_matmul():
            got = gg.sweep_gm(w.gs, w.kinks, gg.to_gm(s.to(dev), w.comp.G), seeds[0].to(dev), v0[0].to(dev), QR_R,
                              False)
    finally:
        gg.glauber = old
    check(len(stats["seen"]) == len(record), f"{len(stats['seen'])} card decisions, {len(record)} on the CPU")
    check(torch.equal(got.cpu(), want), "full-width gm sweep: the planes differ after the replayed decisions")
    _, _, keys_card = threefry_chain(key_tensor(w.key_data, dev), plan, 1, 1)
    check(torch.equal(keys_card.cpu(), keys), "full-width gm sweep: keys differ")
    return stats["decisions"], stats["ties"], stats["max_dd"]


def phase_compare_qmcrunner(dev):
    """The generic k-local engine on the card against the same engine on the
    CPU: QmcRunner on a 5-ring with ZZ, X, XX and ZZZ terms and a free sixth
    variable, on both routes (forced) with and without do_loop: states,
    samples, bond counts and keys bit for bit, energies within QMC_E_RTOL; the
    hard family at n = 128 on each route forced takes it; one full-width gm
    sweep of the hard n = 32 system with its ties counted
    (qr_full_width_sweep); threefry_chain with the generic sweep's slots
    (fan, slice, bits) against its numpy version bit for bit: a plan of every
    kind, the do_loop plan, and the hard n = 32 plan at 100 sweeps x R = 64.
    Returns the largest |difference| of the chain."""
    from pyisingmontecarlo_tpu_torch.engines import generic as ge
    from pyisingmontecarlo_tpu_torch.engines import generic_gm as gg
    from pyisingmontecarlo_tpu_torch.rng import key_tensor, threefry_chain, threefry_chain_reference

    for route, mode in (("gm", "1"), ("classic", "0")):
        for loop in (False, True):
            res = {}
            with _route(mode):
                for d in ("cpu", dev):
                    q = qmc_runner(6, 8, hard_terms(6, ring=5), d, seed=3, do_loop_updates=loop)
                    es, ss = q.run_sampling(QR_BETA, 6, sampling_wait_buffer=2, sampling_freq=2)
                    counts = q.run_bond_sampling(QR_BETA, 2)
                    res[str(d)] = (q._w.s.cpu().numpy(), ss, counts, q._w.key_data, es, q._w.use_gm)
            a, b = res["cpu"], res[str(dev)]
            check(a[5] == b[5] == (route == "gm"), f"compare-qmcrunner: route {a[5]} {b[5]}, want {route}")
            diff = [int((x != y).sum()) for x, y in zip(a[:4], b[:4])]
            check(sum(diff) == 0, f"compare-qmcrunner {route}, do_loop {loop}: {diff} differing values, card vs CPU")
            err = float(np.abs(a[4] - b[4]).max() / np.abs(a[4]).max())
            check(err <= QMC_E_RTOL, f"compare-qmcrunner {route}, do_loop {loop}: energies differ by {err:.3g}")
            print(f"compare-qmcrunner: QmcRunner on a 5-ring (ZZ, X, XX, ZZZ) and a free variable, R=8, {route} route, "
                  f"do_loop {loop}: run_sampling (wait 2, 6 sweeps, freq 2) and run_bond_sampling: card == CPU bit for "
                  f"bit (states, samples, bond counts, keys); energies within {QMC_E_RTOL:g} relative", flush=True)
    for route, mode in (("gm", "1"), ("classic", "0")):  # the gate admits gm at n = 128: G*n*TT under PMC_GM_MAX
        with _route(mode):
            w = qmc_runner(QR_CROSS_N, QR_R, hard_terms(QR_CROSS_N), dev)._ensure(QR_BETA)
        check(w.use_gm == (route == "gm"), f"compare-qmcrunner: the hard family at n={QR_CROSS_N}, {route} forced: "
                                           f"use_gm {w.use_gm}")
        print(f"compare-qmcrunner: the hard family at n={QR_CROSS_N}, R={QR_R} (G={w.comp.G}, "
              f"G*n*TT={w.comp.G * QR_CROSS_N * w.comp.nterms}), {route} route forced: taken", flush=True)
    t0 = time.perf_counter()
    decisions, ties, max_dd = qr_full_width_sweep(dev)
    print(f"compare-qmcrunner: one gm sweep of the hard system at full width (n={QR_N}, R={QR_R}, beta {QR_BETA}; the "
          f"card replays the CPU's decisions): {decisions} Glauber decisions, {ties} differ, all ties (deltas within "
          f"{QR_DELTA_ATOL:g} + {QR_DELTA_RTOL:g} |delta|); largest |delta difference| {max_dd:.3g}; planes and keys "
          f"equal ({time.perf_counter() - t0:.1f} s)", flush=True)
    with _route(None):
        w = qmc_runner(QR_N, QR_R, hard_terms(QR_N), "cpu")._ensure(QR_BETA)
    rows, lt = w.comp.G * QR_N, w.ltau  # a gm plane of the hard system: [G*n, lt*R]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((rows, lt * QR_R)).astype(np.float32) * 1e3)
    card, cpu = gg._sum_slabs(x.to(dev), QR_R).cpu(), gg._sum_slabs(x, QR_R)
    block = gg._sum_slabs(x.to(dev).reshape(rows, lt, QR_R)[:, :, 8:24].reshape(rows, -1), 16).cpu()
    check(torch.equal(card, cpu) and torch.equal(block, card[:, 8:24]),
          "compare-qmcrunner: the gm slab sum on the card != the CPU's slab-by-slab sum, or a replica block's")
    print(f"compare-qmcrunner: the gm route's slab sum of a [{rows}, {lt} x {QR_R}] plane of f32 normals x 1000: card "
          f"== CPU slab by slab bit for bit, and a block of 16 replicas sums as the whole batch", flush=True)
    plan = ge.sweep_plan(w.comp, w.ltau, False, gm=True)
    loop_plan = ge.sweep_plan(w.comp, w.ltau, True)
    every = [0, (3, 5), 1, (4, 10), 2, (5, 33), (3, 0), (4, 70000), (5, 0), (3, 1), (4, 1)]
    err = 0
    for name, p, T, R, seed in (("every slot kind", every, 64, 33, 41), ("the do_loop plan", loop_plan, 20, QR_R, 42),
                                ("the hard n=32 plan", plan, 100, QR_R, 43)):
        kd = _keys(R, seed)
        t0 = time.perf_counter()
        want = threefry_chain_reference(kd, p, T, 1000)
        plain_ms = (time.perf_counter() - t0) * 1e3
        got = [g.cpu().numpy() for g in threefry_chain(key_tensor(kd, dev), p, T, 1000)]
        want = [want[0], want[1], key_tensor(want[2], "cpu").numpy()]
        for g, x in zip(got, want):
            check(g.shape == x.shape, f"compare-qmcrunner {name}: shape {g.shape} vs {x.shape}")
            err = max(err, int(np.abs(g.astype(np.int64) - x.astype(np.int64)).max()) if g.size else 0)
        check(err == 0, f"compare-qmcrunner: threefry_chain of {name} != its numpy version (max |diff| {err})")
        print(f"compare-qmcrunner: threefry_chain, {name} ({len(p)} slots, {sum(_slot_blocks(k) for k in p)} blocks a "
              f"step, x {T} x R={R}) == its numpy version bit for bit (seeds {got[0].shape}, int words {got[1].shape}; "
              f"numpy {plain_ms:.3f} ms)", flush=True)
    return err


def _qr_rate(q, slope, beta=QR_BETA):
    """(sweeps/s, the two calls' walls) of run_sampling as the benches take
    it: the slope between a ``slope[0]``- and a ``slope[1]``-sweep call, after
    a 10-sweep warm-up."""
    q.run_sampling(beta, 10)
    wall = {}
    for T in slope:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q.run_sampling(beta, T)
        torch.cuda.synchronize()
        wall[T] = time.perf_counter() - t0
    return (slope[1] - slope[0]) / (wall[slope[1]] - wall[slope[0]]), wall


def phase_main_qmcrunner(dev, smi):
    """The QmcRunner main path through run_sampling on the card, as the
    benches time it (depth cut to a quarter): the hard n = 32 system (50 and
    200 sweeps) and the 64-chain (100 and 400): sweeps/s and site-subslice
    updates/s, the route,
    the host set-up (compile_terms, compile_gm, the device tables), torch and
    device operations a sweep, device ms a sweep and the idle share
    (torch.profiler over a 20-sweep call), the threefry_chain launches (one a
    call). Checks energies and samples, and the chain's energy against the
    exact free-fermion one. Returns (threefry_chain launches, {name: sweeps/s})."""
    from pyisingmontecarlo_tpu_torch.engines import generic as ge
    from pyisingmontecarlo_tpu_torch.engines import generic_gm as gg

    launches, rates = 0, {}
    for name, n, terms, slope in (("hard n=32", QR_N, hard_terms(QR_N), QR_SLOPE),
                                  ("64-chain", 64, chain_terms(64), QR_CHAIN_SLOPE)):
        with _route(None):
            t0 = time.perf_counter()
            q = qmc_runner(n, QR_R, terms, dev)
            w = q._ensure(QR_BETA)
            torch.cuda.synchronize()
            setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        comp = ge.compile_terms(n, q.terms.terms, w.dtau)
        t_terms = time.perf_counter() - t0
        t0 = time.perf_counter()
        gg.compile_gm(comp, n, "cpu")
        t_gm = time.perf_counter() - t0
        reset_counts()
        rate, wall = _qr_rate(q, slope)
        counts = read_counts()
        check(counts == counts_only(keychain=3), f"{name}: launch counts {counts}, want 3 threefry_chain launches only")
        launches += counts["keychain"]
        rates[name] = rate
        es, ss = q.run_sampling(QR_BETA, 40, sampling_freq=4)
        check(es.shape == (QR_R,) and np.isfinite(es).all() and ss.shape == (QR_R, 10, n) and ss.dtype == np.bool_,
              f"{name}: energies {es.shape}, samples {ss.shape} {ss.dtype}")
        check(np.array_equal(ss[:, -1], (w.s[:, :, 0] == 1).cpu().numpy()), f"{name}: the last sample != slice 0")
        e, se = es.mean() / n, es.std(ddof=1) / np.sqrt(QR_R) / n
        if name == "64-chain":
            exact = chain_energy(n, QR_BETA, 1.0)
            check(abs(e - exact) < 4 * se + 0.03, f"64-chain: e/site {e} vs exact {exact} (se {se})")
            e_line = f"e/site {e:.5f} (exact free-fermion {exact:.5f}, se {se:.5f})"
        else:
            check(-3.0 < e < -0.8, f"hard n=32: e/site {e}")
            e_line = f"e/site {e:.5f} (se {se:.5f})"
        steps = 20
        ops, dlaunch, idle, per = _profile_call(lambda: q.run_sampling(QR_BETA, steps), steps)
        dev_line = ("device time not measured (the profiler recorded none)" if per is None else
                    f"{dlaunch:.1f} device operations a sweep, {sum(per.values()) / steps:.3f} device ms a sweep, "
                    f"device idle {idle:.2f}% of the call; device ms by kernel "
                    + ", ".join(f"{k} {v:.3f}" for k, v in sorted(per.items())))
        print(f"main-qmcrunner: {name} (n={n}, R={QR_R}, beta {QR_BETA}, {len(q.terms.terms)} terms; G={w.comp.G}, "
              f"{len(w.comp.color_sites)} site colors, {len(w.comp.tkink)} term-kink colors, L_tau={w.ltau}, "
              f"Lt={w.Lt}; {'gm' if w.use_gm else 'classic'} route, {len(ge.sweep_plan(w.comp, w.ltau, False, True))} "
              f"key slots a sweep) on {smi}: run_sampling slope {slope[0]} -> {slope[1]} sweeps "
              f"({wall[slope[0]]:.3f} s, {wall[slope[1]]:.3f} s): {rate:.3f} sweeps/s = "
              f"{QR_R * n * w.Lt * rate:.4g} site-subslice updates/s; set-up {setup:.3f} s (QmcRunner, compile_terms, "
              f"compile_gm and device tables; compile_terms alone {t_terms:.3f} s, compile_gm's host part "
              f"{t_gm:.3f} s); {counts['keychain']} threefry_chain launches (one a call); {e_line}", flush=True)
        print(f"main-qmcrunner: {name}, a {steps}-sweep run_sampling under torch.profiler on {smi}: {ops:.1f} torch "
              f"operations a sweep; {dev_line}", flush=True)
    return launches, rates


def phase_physics_qmcrunner(dev):
    """<E> on the card within 4 se + 0.1 of dense diagonalization (the bound
    of tests/test_qmcrunner.py's XX and ZZZ checks): a 6-ring with ZZ, X and
    XX bonds (beta 0.5) and an 8-ring with ZZ, X and ZZZ triples (beta 1),
    256 replicas each."""
    out = []
    for name, n, kw, beta, wait, T in QR_PHYS:
        terms = hard_terms(n, **kw)
        with _route(None):
            q = qmc_runner(n, 256, terms, dev, seed=5)
            t0 = time.perf_counter()
            es, _ = q.run_sampling(beta, T, sampling_wait_buffer=wait)
            dt = time.perf_counter() - t0
        dense = [(np.asarray(mat, np.float64).reshape(2 ** len(vs), 2 ** len(vs)) if kind == "full"
                  else np.diag(mat), tuple(vs)) for kind, mat, vs in terms]
        exact = dense_terms_energy(n, dense, beta)
        m, se = es.mean(), es.std(ddof=1) / np.sqrt(len(es))
        check(abs(m - exact) < 4 * se + 0.1, f"physics-qmcrunner {name}: <E> {m} vs dense {exact} (se {se})")
        out.append(f"{name}, beta {beta}, wait {wait} + {T} sweeps ({dt:.1f} s): <E> {m:.4f} (dense {exact:.4f}, "
                   f"se {se:.4f}, {'gm' if q._w.use_gm else 'classic'} route)")
    print("physics-qmcrunner: " + "; ".join(out), flush=True)


def dense_terms_energy(nvars, terms, beta):
    """<E> by dense diagonalization of H = sum_t M_t, each M_t a 2^k x 2^k
    matrix over its variables (local index sum_m bit_m << m, bit 1 = up;
    tests/helpers.dense_terms_energy)."""
    dim = 2**nvars
    H = np.zeros((dim, dim))
    for mat, vs in terms:
        k = len(vs)
        for st in range(dim):
            idx_in = sum(((st >> vs[m]) & 1) << m for m in range(k))
            for idx_out in range(2**k):
                if mat[idx_in, idx_out] == 0.0:
                    continue
                st_out = st
                for m in range(k):
                    st_out = (st_out & ~(1 << vs[m])) | (((idx_out >> m) & 1) << vs[m])
                H[st_out, st] += mat[idx_in, idx_out]
    w = np.linalg.eigvalsh(H)
    zw = np.exp(-beta * (w - w.min()))
    return float((w * zw).sum() / zw.sum())


# compare-threefry-bits: one key over 1 M and 8 M counters (8 M: the spatial sweep's draws a phase at bench.py's
# 1024^2 x 8), R keys, an odd size
BITS_CASES = (("1 M counters, one key", 1, 1 << 20), ("8 M counters, one key", 1, 8 << 20),
              ("64 keys x 4097 counters", 64, 4097), ("3 keys x 1000003 counters", 3, 1000003))
# main-parallel: the spatial sweep at bench.py's shape, the tau sweep at examples/tau_sharded_tfim.py's
SP_SWEEPS = 20
TAU_N, TAU_LTAU, TAU_R, TAU_BETA, TAU_SWEEPS = 16, 64, 128, 2.0, 100
PAR_LADDER_T = 500


def phase_compare_threefry_bits(dev):
    """threefry_bits (csrc/keychain.cu) against rng.random_bits and
    rng.uniform_f32 (numpy), bit for bit, in both modes, at BITS_CASES.
    Returns the largest |difference|."""
    from pyisingmontecarlo_tpu_torch.rng import key_tensor, random_bits, threefry_bits, uniform_f32

    err = 0
    for name, R, n in BITS_CASES:
        kd = _keys(R, n % 997)
        keys = key_tensor(kd, dev)
        got = threefry_bits(keys, n).cpu().numpy().view(np.uint32)
        want = random_bits(kd, n)
        gu = threefry_bits(keys, n, uniform=True).cpu().numpy()
        wu = uniform_f32(kd, n)
        e = max(int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()),
                int(np.abs(gu.view(np.uint32).astype(np.int64) - wu.view(np.uint32).astype(np.int64)).max()))
        err = max(err, e)
        check(e == 0 and got.shape == want.shape == (R, n), f"compare-threefry-bits {name}: max |diff| {e}")
        print(f"compare-threefry-bits: {name}: bits and uniforms equal rng.random_bits / uniform_f32 bit for bit",
              flush=True)
    return err


def _equal_results(a, b, what):
    """Nested results (tuples, lists, arrays, numbers) equal bit for bit."""
    if isinstance(a, (tuple, list)):
        check(isinstance(b, (tuple, list)) and len(a) == len(b), f"{what}: structure differs")
        for x, y in zip(a, b):
            _equal_results(x, y, what)
        return
    x, y = np.asarray(a), np.asarray(b)
    check(x.shape == y.shape and x.dtype == y.dtype and np.array_equal(x, y), f"{what}: results differ")


def _wall(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _sharded_vs_plain(calls, a, b, what):
    """``calls(a)`` (sharded) and ``calls(b)`` (unsharded) twice, in the order
    a, b, b, a, each pair bit for bit equal; returns the host walls of each
    second call (b first, after the first pair warmed both up)."""
    ra, _ = _wall(lambda: calls(a))
    rb, _ = _wall(lambda: calls(b))
    _equal_results(ra, rb, what)
    rb, tb = _wall(lambda: calls(b))
    ra, ta = _wall(lambda: calls(a))
    _equal_results(ra, rb, what)
    return ra, ta, tb


def phase_compare_parallel(dev, smi):
    """The sharded paths on a one-rank NCCL group on the card: QmcRunner on both
    routes, QmcIsing and the tempering ladder, replica-sharded, each bit for bit
    its unsharded run on the card (and its host wall beside); the spatial and
    tau-sharded sweeps bit for bit the same sweeps on the CPU (one shard, no
    collectives). The host walls are of a second round of calls, in the order
    unsharded, sharded. Returns the meshes of main-parallel."""
    import torch.distributed as dist

    from pyisingmontecarlo_tpu_torch import QmcIsing
    from pyisingmontecarlo_tpu_torch.parallel import mesh as pmesh
    from pyisingmontecarlo_tpu_torch.parallel import replica as prep
    from pyisingmontecarlo_tpu_torch.parallel import spatial as psp
    from pyisingmontecarlo_tpu_torch.parallel import tau as ptau
    from pyisingmontecarlo_tpu_torch.parallel import tempering as ptemp
    from pyisingmontecarlo_tpu_torch.rng import fold_all

    pmesh.init_distributed(device=dev)
    want = "nccl" if dev.type == "cuda" else "gloo"
    check(dist.get_backend() == want and dist.get_world_size() == 1, f"backend {dist.get_backend()}, want {want}")
    meshes = {name: pmesh.make_mesh((1,), (name,), device=dev.type) for name in ("replica", "space", "tau")}
    out = []
    for mode in ("0", "1"):
        with _route(mode):
            a, b = (qmc_runner(QR_N, QR_R, hard_terms(QR_N), dev, seed=5) for _ in range(2))
            prep.shard_runner(a, meshes["replica"], beta=QR_BETA)
            b._ensure(QR_BETA)
        calls = lambda q: [q.run_sampling(QR_BETA, 4, sampling_freq=2), q.run_bond_sampling(QR_BETA, 2, sampling_freq=1),
                           q.get_graph_itime(QR_R - 1)]
        _, ta, tb = _sharded_vs_plain(calls, a, b, f"compare-parallel QmcRunner PMC_GENERIC_GM={mode}")
        out.append(f"QmcRunner hard n={QR_N}, R={QR_R}, {'gm' if a._w.use_gm else 'classic'} route: 6 sweeps sharded "
                   f"{ta:.3f} s, unsharded {tb:.3f} s")
    edges = glass_edges(256)
    a, b = (QmcIsing(edges, QMC_GAMMA, 0.0, num_experiments=16, seed=QMC_SEED, device=dev) for _ in range(2))
    prep.shard_qmcising(a, meshes["replica"], beta=QMC_BETA)
    b._ensure(QMC_BETA)
    calls = lambda q: [q.run_sampling(QMC_BETA, 6, sampling_freq=2), q.run_bond_sampling(QMC_BETA, 2)]
    _, ta, tb = _sharded_vs_plain(calls, a, b, "compare-parallel QmcIsing")
    out.append(f"QmcIsing 256-site glass, R=16: 8 sweeps sharded {ta:.3f} s, unsharded {tb:.3f} s")
    a, b = pt_ladder(dev), pt_ladder(dev)
    ptemp.shard_ladder(a, meshes["replica"])
    calls = lambda lt: [lt.qmc_timesteps(3), lt.qmc_timesteps_sample(20, 1), lt.qmc_timesteps_sample(9, 2, 3),
                        lt.get_total_swaps(), lt._materialize()["s"].cpu().numpy()]
    ra, ta, tb = _sharded_vs_plain(calls, a, b, "compare-parallel ladder")
    check(ra[3] > 0, "compare-parallel ladder: no swap accepted")
    out.append(f"ladder 12^2 +-J, R={PT_R}: 32 sweeps sharded {ta:.3f} s, unsharded {tb:.3f} s ({ra[3]} swaps)")
    rng = np.random.default_rng(4)
    s = torch.from_numpy(rng.integers(0, 2, (4, 128, 128)).astype(np.int8) * 2 - 1)
    key = np.array([0, 9], np.uint32)
    card = psp.sharded_sweeps_2d(meshes["space"], s, key, 0.4, -1.0, 0.0, 10).cpu()
    cpu = psp._sweeps_local(s.clone(), fold_all(key[None], 0)[0], 0.4, -1.0, 0.0, 10, 0, None)
    check(torch.equal(card, cpu) and (card != s).any(), "compare-parallel spatial: card != CPU")
    out.append("spatial 128^2 x 4, 10 sweeps: card == CPU")
    for kind, size, nvars, L, R in (("ring", 0, 16, 64, 16), ("torus", 8, 64, 16, 8)):
        s = torch.from_numpy(rng.integers(0, 2, (R, nvars, L)).astype(np.int8) * 2 - 1)
        card = ptau.sharded_wl_sweeps(s, key, meshes["tau"], 2.0, 1.0, -1.0, 0.0, 10, kind=kind, size=size).cpu()
        dtau = 2.0 / L
        ktau = -0.5 * float(np.log(np.tanh(dtau)))
        cpu = ptau._sweeps_local(s.clone(), fold_all(key[None], 0)[0], dtau, ktau, kind, size or nvars, -1.0, 0.0, 10,
                                 0, None)
        check(torch.equal(card, cpu) and (card != s).any(), f"compare-parallel tau {kind}: card != CPU")
        out.append(f"tau {kind} {nvars} sites, L_tau={L}, R={R}, 10 sweeps: card == CPU")
    print(f"compare-parallel on {smi}, one-rank NCCL group: each sharded path bit for bit its unsharded run "
          f"(replica paths) or the CPU's (spatial, tau): " + "; ".join(out), flush=True)
    return meshes


def _profiled(fn, names, counter, want, **also):
    """``fn()`` once under torch.profiler: the device kernels whose names hold
    one of ``names`` beside the launches the wrapper counted under ``counter``
    in that call (the profiler may miss a window's first kernel, so the count
    is the check: it must be ``want``, and the other counters ``also`` or 0)
    and the device's idle share, as text; 'not measured' when the profiler
    records no device time."""
    reset_counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = read_counts()
    check(counts == counts_only(**{counter: want}, **also),
          f"profiled call: launch counts {counts}, want {counter}={want} and {also or 'no other'}")
    launched = f"{counts[counter]} {'threefry_bits' if counter == 'bits' else counter} counted"
    dev_t = _device_times(prof, names, everything=True)
    if dev_t is None:
        return f"profiler: not measured (no device time recorded; {launched})"
    per, busy, span = dev_t
    return (f"profiler ({launched}): " + ", ".join(f"{n} {np.mean(v):.3f} us x {len(v)}"
                                                   for n, v in sorted(per.items()))
            + f"; device busy {busy:.1f} of {span:.1f} us, idle {100 * (1 - busy / span):.2f}%")


def phase_main_parallel(dev, smi, meshes):
    """The sharded paths' main shapes on the one-rank NCCL group: the
    tempering bench's ladder (qmc_timesteps_sample(500, replica_swap_freq=1),
    ladder_resident once a sweep), the spatial sweep at bench.py's 1024^2 x 8
    and the tau sweep at the tau example's 16-ring (L_tau = 64, 128 replicas),
    each one threefry_bits launch a phase; sweeps/s beside the unsharded
    route's and, for spatial and tau, beside the same sweeps with no mesh.
    Returns (the ladder's launch counts, threefry_bits launches, the ladder's
    sweeps/s sharded and unsharded)."""
    import torch.distributed as dist

    from pyisingmontecarlo_tpu_torch import Lattice
    from pyisingmontecarlo_tpu_torch.engines import classical as ce
    from pyisingmontecarlo_tpu_torch.engines import worldline as wlg
    from pyisingmontecarlo_tpu_torch.graph import compile_graph, grid_2d_edges
    from pyisingmontecarlo_tpu_torch.parallel import spatial as psp
    from pyisingmontecarlo_tpu_torch.parallel import tau as ptau
    from pyisingmontecarlo_tpu_torch.parallel import tempering as ptemp
    from pyisingmontecarlo_tpu_torch.rng import fold_all

    sharded, plain = pt_ladder(dev), pt_ladder(dev)
    ptemp.shard_ladder(sharded, meshes["replica"])
    for lt in (sharded, plain):
        lt.qmc_timesteps_sample(20, replica_swap_freq=1)  # build and warm up
    reset_counts()
    (states, es), t_first = _wall(lambda: sharded.qmc_timesteps_sample(PAR_LADDER_T, replica_swap_freq=1))
    counts = counts_ladder = read_counts()
    check(counts == counts_only(ladder_resident=PAR_LADDER_T, keychain=2),
          f"main-parallel ladder: launch counts {counts}")
    check(states.shape == (PT_R, PAR_LADDER_T, PT_SIDE**2) and np.isfinite(es).all() and es[-8:].mean() < es[:8].mean(),
          f"main-parallel ladder: states {states.shape}, <E> {es[:8].mean()} .. {es[-8:].mean()}")
    walls = {"sharded": [t_first], "unsharded": []}
    for name in ("unsharded", "sharded", "sharded", "unsharded"):
        lt = sharded if name == "sharded" else plain
        walls[name].append(_wall(lambda: lt.qmc_timesteps_sample(PAR_LADDER_T, replica_swap_freq=1))[1])
    rate = {k: PAR_LADDER_T / min(v) for k, v in walls.items()}
    from pyisingmontecarlo_tpu_torch.parallel.comm import MeshAxis, gather_axis, ring_shift

    axis = MeshAxis(meshes["replica"], "replica")
    feats = torch.zeros((PT_R, 2 * PT_SIDE**2 + 2), dtype=torch.int64, device=dev)  # a swap step's features
    plane = torch.zeros((1, PT_SIDE**2, PT_LTAU), dtype=torch.int8, device=dev)
    gather_axis(feats, axis)
    _, t_gather = _wall(lambda: [gather_axis(feats, axis) for _ in range(200)])
    _, t_shift = _wall(lambda: [ring_shift(plane, axis) for _ in range(200)])

    def nccl_gather():  # the all_gather a rank of a wider axis issues; gather_axis issues none on one rank
        parts = [torch.empty_like(feats)]
        dist.all_gather(parts, feats, group=axis.group)
        return parts[0]

    check(torch.equal(nccl_gather(), feats), "main-parallel: a one-rank NCCL all_gather changed its input")
    _, t_nccl = _wall(lambda: [nccl_gather() for _ in range(200)])
    prof_ladder = _profiled(lambda: sharded.qmc_timesteps_sample(20, replica_swap_freq=1), ("ladder_resident", "nccl"),
                            "ladder_resident", 20, keychain=2)  # and the key tables' two chains
    print(f"main-parallel: ladder on {smi}: LatticeTempering.qmc_timesteps_sample({PAR_LADDER_T}, "
          f"replica_swap_freq=1), 12^2 +-J, {PT_R} replicas, L_tau={PT_LTAU}, sharded on a one-rank mesh: "
          f"{counts['ladder_resident']} ladder_resident launches, 0 multi-launch; {rate['sharded']:.2f} sweeps/s "
          f"sharded against {rate['unsharded']:.2f} unsharded (best of runs {walls}); the swap step's gather_axis of "
          f"{tuple(feats.shape)} int64 features over the one-rank group {t_gather / 200 * 1e6:.2f} us a call (no "
          f"collective on one rank; a one-rank NCCL all_gather of them {t_nccl / 200 * 1e6:.1f} us), a ring shift of "
          f"one replica plane {t_shift / 200 * 1e6:.2f} us (host wall, synchronized); 20 sharded steps' "
          f"{prof_ladder}", flush=True)
    bits = counts["bits"]

    rng = np.random.default_rng(0)
    s = torch.from_numpy(rng.integers(0, 2, (BENCH_R, BENCH_L, BENCH_L)).astype(np.int8) * 2 - 1)
    key = np.array([0, 0], np.uint32)
    psp.sharded_sweeps_2d(meshes["space"], s, key, BENCH_BETA, -1.0, 0.0, 2)  # warm up
    reset_counts()
    out, t_sh = _wall(lambda: psp.sharded_sweeps_2d(meshes["space"], s, key, BENCH_BETA, -1.0, 0.0, SP_SWEEPS))
    counts = read_counts()
    check(counts == counts_only(bits=2 * SP_SWEEPS), f"main-parallel spatial: launch counts {counts}")
    bits += counts["bits"]
    x = out.to(dev, torch.float32)
    e = float(-((x * x.roll(1, 1)).sum() + (x * x.roll(1, 2)).sum()) / x.numel())
    check(out.shape == s.shape and -2.0 < e < -0.7, f"main-parallel spatial: state {tuple(out.shape)}, e/site {e}")
    s_dev = s.to(dev)
    _, t_local = _wall(lambda: psp._sweeps_local(s_dev, fold_all(key[None], 0)[0], BENCH_BETA, -1.0, 0.0, SP_SWEEPS, 0,
                                                 None))
    lat = Lattice(grid_2d_edges(BENCH_L, BENCH_L, -1.0), seed_gen=0, device=dev)
    lat.run_monte_carlo(BENCH_BETA, SP_SWEEPS, BENCH_R)
    _, t_kernel = _wall(lambda: lat.run_monte_carlo(BENCH_BETA, SP_SWEEPS, BENCH_R))
    prof_sp = _profiled(lambda: psp.sharded_sweeps_2d(meshes["space"], s, key, BENCH_BETA, -1.0, 0.0, 5),
                        ("threefry_bits", "nccl"), "bits", 10)
    print(f"main-parallel: spatial on {smi}: sharded_sweeps_2d at {BENCH_L}^2 x {BENCH_R}, beta {BENCH_BETA}, "
          f"{SP_SWEEPS} sweeps on a one-rank space mesh: {counts['bits']} threefry_bits launches, "
          f"{SP_SWEEPS / t_sh:.2f} sweeps/s ({t_sh:.4f} s; e/site {e:.4f}); the same sweeps with no mesh "
          f"{SP_SWEEPS / t_local:.2f} sweeps/s; the unsharded route (Lattice.run_monte_carlo, sq2d_tiled) "
          f"{SP_SWEEPS / t_kernel:.2f} sweeps/s; 5 sharded sweeps' {prof_sp}", flush=True)

    edges = [((i, (i + 1) % TAU_N), -1.0) for i in range(TAU_N)]
    s = ptau.bernoulli_states([0, 0], (TAU_R, TAU_N, TAU_LTAU))
    ptau.sharded_wl_sweeps(s, np.array([0, 1], np.uint32), meshes["tau"], TAU_BETA, 1.0, -1.0, 0.0, 2)  # warm up
    reset_counts()
    s, t_tau = _wall(lambda: ptau.sharded_wl_sweeps(s, np.array([0, 1], np.uint32), meshes["tau"], TAU_BETA, 1.0,
                                                    -1.0, 0.0, TAU_SWEEPS))
    counts = read_counts()
    check(counts == counts_only(bits=12 * TAU_SWEEPS), f"main-parallel tau: launch counts {counts}")
    bits += counts["bits"]
    s = ptau.sharded_wl_sweeps(s, np.array([0, 2], np.uint32), meshes["tau"], TAU_BETA, 1.0, -1.0, 0.0, TAU_SWEEPS)
    ga = ce.device_graph(compile_graph(edges))
    p = wlg.make_params(np.full(TAU_R, TAU_BETA), 1.0, 0.0, TAU_LTAU)
    es = wlg.total_energy(ga, p, s.cpu()).numpy().astype(np.float64) / TAU_N
    em, se, exact = es.mean(), es.std(ddof=1) / np.sqrt(TAU_R), chain_energy(TAU_N, TAU_BETA, 1.0)
    # one tau shard leaves the wrap bond unfrozen and lets both its ends flip in one cluster phase, as the JAX
    # package's sharded_wl_sweeps does: e/site about 0.03 below exact at this shape (2 and 4 shards sample it
    # exactly); the check is a sanity bound, not the physics check
    check(np.isfinite(es).all() and abs(em - exact) < 0.1, f"main-parallel tau: e/site {em} vs exact {exact}")
    dtau = TAU_BETA / TAU_LTAU
    s_dev = s.to(dev)
    _, t_local = _wall(lambda: ptau._sweeps_local(s_dev, fold_all(np.array([[0, 3]], np.uint32), 0)[0], dtau,
                                                  -0.5 * float(np.log(np.tanh(dtau))), "ring", TAU_N, -1.0, 0.0,
                                                  TAU_SWEEPS, 0, None))
    lat = Lattice(edges, seed_gen=0, dtau=dtau, device=dev)
    lat.set_transverse_field(1.0)
    lat.run_quantum_monte_carlo(TAU_BETA, 10, TAU_R)
    _, t_kernel = _wall(lambda: lat.run_quantum_monte_carlo(TAU_BETA, TAU_SWEEPS, TAU_R))
    prof_tau = _profiled(lambda: ptau.sharded_wl_sweeps(s, np.array([0, 4], np.uint32), meshes["tau"], TAU_BETA, 1.0,
                                                        -1.0, 0.0, 5), ("threefry_bits", "nccl"), "bits", 60)
    print(f"main-parallel: tau on {smi}: sharded_wl_sweeps on the {TAU_N}-ring, L_tau={TAU_LTAU}, {TAU_R} replicas, "
          f"beta {TAU_BETA}, {TAU_SWEEPS} sweeps on a one-rank tau mesh: {counts['bits']} threefry_bits launches, "
          f"{TAU_SWEEPS / t_tau:.2f} sweeps/s; e/site after {2 * TAU_SWEEPS} sweeps {em:.5f} (exact {exact:.5f}, "
          f"se {se:.5f}; one shard's bias, see the check); the same sweeps with no mesh {TAU_SWEEPS / t_local:.2f} sweeps/s; the unsharded route "
          f"(Lattice.run_quantum_monte_carlo, the worldline kernel) {TAU_SWEEPS / t_kernel:.2f} sweeps/s; 5 sharded "
          f"sweeps' {prof_tau}", flush=True)
    return counts_ladder, bits, rate


def _same_arrays(a, b):
    """Whether two tuples of pass outputs (arrays and ints) are equal, dtype for dtype."""
    def same(x, y):
        if isinstance(x, np.ndarray):
            return isinstance(y, np.ndarray) and x.dtype == y.dtype and np.array_equal(x, y)
        return type(x) is type(y) and x == y

    return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))


def _native_calls():
    """{pass: the calls of the native graph library's pass so far}."""
    from pyisingmontecarlo_tpu_torch import _native_graph as ng

    return {name: getattr(ng, name).calls for name in ("build_ell", "color_sites", "color_edges", "strong_color_edges")}


def phase_graph_native(dev, smi):
    """The native graph library built on this host from the checkout's
    source, its four passes against the python passes, array for array and
    dtype for dtype, on benches/bench_classical_graph.py's 4-regular +-J glass
    at n = 4096 and 16384 and BASELINE.json config 2's 48^2 triangular
    lattice, with each graph's set-up both ways (the ELL adjacency and the
    three colorings, ms on the host); then ClassicIsing on the n = 16384
    glass, which must take the native build."""
    from pyisingmontecarlo_tpu_torch import ClassicIsing
    from pyisingmontecarlo_tpu_torch import _native_graph as ng
    from pyisingmontecarlo_tpu_torch import graph as tg
    from pyisingmontecarlo_tpu_torch.models import triangular_edges

    check(ng.available(), f"no {ng.COMPILER} on PATH: the native graph library cannot be built")
    lib = ng.build()
    ng.load()
    with tempfile.TemporaryDirectory(dir=ng.BUILD) as fresh:  # earlier phases built the package's copy: time one
        t0 = time.perf_counter()
        ng.build(ng.SOURCE, fresh)
        build_s = time.perf_counter() - t0
    print(f"graph-native: {ng.COMPILER} {' '.join(ng.FLAGS)} builds {ng.SOURCE.name} from the checkout in "
          f"{build_s:.3f} s on the host of {smi} (into an empty directory); {lib.name} loaded", flush=True)
    passes = (("ELL", ng.build_ell, tg._build_ell_numpy), ("site colors", ng.color_sites, tg._color_sites_python),
              ("edge colors", ng.color_edges, tg._color_edges_python),
              ("strong edge colors", ng.strong_color_edges, tg._strong_color_edges_python))
    graphs = ((f"4-regular +-J glass n={GLASS_NS[0]}", glass_edges(GLASS_NS[0])),
              (f"4-regular +-J glass n={GLASS_NS[1]}", glass_edges(GLASS_NS[1])),
              (f"{TRI_L}^2 triangular", triangular_edges(TRI_L, j=1.0)))
    for name, edges in graphs:
        nvars, ea, eb, ej = tg.parse_edges(edges)
        ms = {"native": {}, "python": {}}
        for pname, native, python in passes:
            args = (nvars, ea, eb, ej) if pname == "ELL" else (nvars, ea, eb)
            out = {}
            for side, fn, reps in (("native", native, 3), ("python", python, 1)):
                best = float("inf")
                for _ in range(reps):
                    t0 = time.perf_counter()
                    out[side] = fn(*args)
                    best = min(best, time.perf_counter() - t0)
                ms[side][pname] = best * 1e3
            got, want = (out[side] if pname == "ELL" else (out[side],) for side in ("native", "python"))
            check(_same_arrays(got, want), f"graph-native: {name}: the native {pname} != the python pass's")
        print(f"graph-native: {name} (n = {nvars}, {len(ea)} edges), set-up on the host of {smi}: native "
              f"{sum(ms['native'].values()):.3f} ms (" + ", ".join(f"{k} {v:.3f}" for k, v in ms["native"].items())
              + f"; the best of 3), python {sum(ms['python'].values()):.1f} ms ("
              + ", ".join(f"{k} {v:.1f}" for k, v in ms["python"].items())
              + "); the four passes' arrays equal, dtype for dtype", flush=True)
    before = _native_calls()
    ci = ClassicIsing(glass_edges(GLASS_NS[1]), num_experiments=GLASS_R, seed=3, device=dev)
    es, _ = ci.run_monte_carlo_sampling(GLASS_BETA, 2)
    took = {k: v - before[k] for k, v in _native_calls().items()}
    check(took["build_ell"] == took["color_sites"] == took["strong_color_edges"] == 1,
          f"graph-native: ClassicIsing on the n={GLASS_NS[1]} glass took native passes {took}")
    check(np.isfinite(es).all(), "graph-native: ClassicIsing's energies are not finite")
    print(f"graph-native: ClassicIsing(glass n={GLASS_NS[1]}, R={GLASS_R}) on {smi} took the native build: "
          f"native calls {took}", flush=True)


def phase_shim(dev):
    """The reference README's first example, verbatim, through py_monte_carlo_torch: the
    default device (the card), run_monte_carlo(1.0, 10, 4) on the 3-site graph."""
    import py_monte_carlo_torch as py_monte_carlo

    edges = [((0, 1), 1.0), ((1, 2), -1.0)]
    reset_counts()
    lat = py_monte_carlo.Lattice(edges)
    es, ss = lat.run_monte_carlo(1.0, 10, 4)
    counts = read_counts()
    check(lat.device.type == "cuda", f"shim: the default device is {lat.device}")
    check(es.shape == (4,) and ss.shape == (4, 3) and es.dtype == np.float64 and ss.dtype == np.bool_,
          f"shim: shapes {es.shape} {ss.shape}, dtypes {es.dtype} {ss.dtype}")
    s = np.where(ss, 1.0, -1.0)
    check(np.array_equal(es, s[:, 0] * s[:, 1] - s[:, 1] * s[:, 2]), f"shim: energies {es} != those of the states")
    print(f"shim: py_monte_carlo_torch.Lattice({edges}).run_monte_carlo(1.0, 10, 4) on {lat.device} "
          f"({torch.cuda.get_device_name(0)}): energies {es.tolist()}, states {ss.shape}; launches {counts}",
          flush=True)


# the twins' physics tolerances (examples phase)
# ferromagnet at L = 32: <|m|> within 4 se + 0.03 of Onsager at beta >= 0.5 (the finite-size shift at L = 32 is
# about +0.001; a replica still in two domains after 2000 sweeps from a random start pulls the mean down by
# about 1/32), and below 0.1 at beta = 0.30 (its finite-size <|m|> ~ sqrt(chi / N) ~ 0.06)
FERRO_TOL, FERRO_HOT_MAX = 0.03, 0.1
# ferromagnet at L = 256: the 2200 sweeps are short of the ~L^2 sweeps that single-flip coarsening needs to
# order the lattice, so <|m|> at beta >= 0.5 lies between the disordered value and Onsager's (+ 4 se + 0.03),
# and at beta = 0.30 below 0.02 (sqrt(chi / N) ~ 0.008)
FERRO_BIG_L, FERRO_BIG_HOT_MAX = 256, 0.02
# TFIM chain: <E>/n within 4 se + 0.03 of the free-fermion energy (the Trotter bias at dtau = 0.05 is below 0.003
# a site), <m^2> falling with Gamma; Trotter: the Richardson estimate within 4 of its standard errors


def phase_examples(dev, smi):
    """Each twin of examples/ through its main([]) on the card (default
    arguments; the ferromagnet also at L = 256): its wall, its kernel
    launches (each twin must launch the kernel its path takes), and its
    physics against the tolerances above."""
    from pyisingmontecarlo_tpu_torch.examples import (ferromagnet_phase_diagram, spin_glass_tempering,
                                                      tfim_quantum_phase_transition, trotter_extrapolation)

    def drive(mod, argv, want):
        reset_counts()
        t0 = time.perf_counter()
        out = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        name = mod.__name__.rsplit(".", 1)[1]
        launched = {k: v for k, v in counts.items() if v}
        check(sum(counts[k] for k in want) > 0, f"examples: {name} {argv} launched none of {want}: {counts}")
        print(f"examples: {name} {argv} on {smi}: {wall:.3f} s wall; launches {launched}", flush=True)
        return out

    for L, argv in ((32, []), (FERRO_BIG_L, [str(FERRO_BIG_L)])):
        rows = drive(ferromagnet_phase_diagram, argv, ("sq2d",))
        (b_hot, m_hot, _, _), cold = rows[0], [r for r in rows if r[0] >= 0.5]
        check(b_hot == 0.30 and m_hot < (FERRO_HOT_MAX if L == 32 else FERRO_BIG_HOT_MAX),
              f"examples: ferromagnet L={L}: <|m|> {m_hot} at beta 0.30")
        for beta, m, se, exact in cold:
            ok = abs(m - exact) < 4 * se + FERRO_TOL if L == 32 else m_hot < m < exact + 4 * se + FERRO_TOL
            check(ok, f"examples: ferromagnet L={L}: <|m|> {m} +- {se} at beta {beta}, Onsager {exact}")
        print(f"examples: ferromagnet L={L}: " + ", ".join(f"beta {b}: {m:.4f} +- {se:.4f} (Onsager {e:.4f})"
                                                        for b, m, se, e in rows), flush=True)

    rows = drive(tfim_quantum_phase_transition, [], ("wl", "wl_resident", "wl_tiled"))
    n, beta = 16, 8.0
    for gamma, _, e, se in rows:
        exact = chain_energy(n, beta, gamma)
        check(abs(e - exact) < 4 * se + 0.03, f"examples: TFIM chain Gamma {gamma}: <E>/n {e} +- {se}, exact {exact}")
    m2 = [r[1] for r in rows]
    check(all(a > b for a, b in zip(m2, m2[1:])), f"examples: TFIM chain <m^2> {m2} does not fall with Gamma")
    print(f"examples: TFIM chain n={n}, beta={beta}: " + ", ".join(
        f"Gamma {g}: <E>/n {e:.5f} +- {se:.5f} (exact {chain_energy(n, beta, g):.5f}), <m^2> {m:.4f}"
        for g, m, e, se in rows), flush=True)

    out = drive(spin_glass_tempering, [], ("ladder", "ladder_resident"))
    es = out["energies"]
    check(out["swaps"] > 0 and es[-1] < es[0], f"examples: glass swaps {out['swaps']}, <E> coldest {es[-1]}, "
                                                f"hottest {es[0]}")
    print(f"examples: glass: {out['swaps']} accepted swaps, <E> hottest {es[0]:.3f}, coldest {es[-1]:.3f}", flush=True)

    ex, rows = drive(trotter_extrapolation, [], ("wl", "wl_resident", "wl_tiled", "keychain"))
    _, e_x, se_x, bias_x = rows[-1]
    check(abs(bias_x) < 4 * se_x, f"examples: Richardson {e_x} +- {se_x}, exact {ex}")
    print(f"examples: Trotter: exact {ex:.5f}; " + ", ".join(f"{label} {e:.5f} +- {se:.5f} (bias {b:+.5f})"
                                                            for label, e, se, b in rows), flush=True)


def main():
    from pyisingmontecarlo_tpu_torch.ops import wl

    seconds = {}

    def timed_phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[fn.__name__[len("phase_"):]] = round(time.perf_counter() - t0, 1)
        return out

    smi = phase_gpu()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    timed_phase(phase_build)
    err = timed_phase(phase_compare, dev)
    launches = timed_phase(phase_main, dev)
    timed_phase(phase_physics, dev)
    wl_errs = timed_phase(phase_compare_wl, dev)
    wl_launches = timed_phase(phase_main_quantum, dev)
    wl_sample_launches = timed_phase(phase_main_quantum_sampling, dev)
    long_launches, long_sample_launches = timed_phase(phase_main_quantum_long, dev)
    resident_launches = timed_phase(phase_main_chain, dev)
    timed_phase(phase_physics_wl, dev)
    ladder_err, ladder_res_err = timed_phase(phase_compare_ladder, dev)
    ladder_res_launches, _, _ = timed_phase(phase_main_tempering, dev)
    ladder_launches, feature_launches = timed_phase(phase_main_tempering_wide, dev)
    timed_phase(phase_physics_tempering, dev)
    long_errs = timed_phase(phase_compare_longline, dev)
    timed_phase(phase_compare_replicas, dev)
    ll_launches = timed_phase(phase_main_quantum_longline, dev, smi)
    llpt_launches = timed_phase(phase_main_tempering_longline, dev, smi)
    chain_err = timed_phase(phase_compare_keychain, dev)
    chain_err = max(chain_err, timed_phase(phase_compare_key_tables, dev))
    timed_phase(phase_compare_classical, dev)
    keychain_launches = timed_phase(phase_main_classical, dev, smi)
    timed_phase(phase_main_classicising, dev, smi)
    timed_phase(phase_physics_classical, dev)
    timed_phase(phase_compare_qmc_generic, dev)
    qmc_keychain_launches, _ = timed_phase(phase_main_qmcising, dev, smi)
    qmc_tiled_launches, qmc_resident_launches = timed_phase(phase_main_qmcising_lattice, dev)
    timed_phase(phase_physics_qmcising, dev)
    qr_chain_err = timed_phase(phase_compare_qmcrunner, dev)
    qr_keychain_launches, _ = timed_phase(phase_main_qmcrunner, dev, smi)
    timed_phase(phase_physics_qmcrunner, dev)
    bits_err = timed_phase(phase_compare_threefry_bits, dev)
    meshes = timed_phase(phase_compare_parallel, dev, smi)
    par_counts, bits_launches, _ = timed_phase(phase_main_parallel, dev, smi, meshes)
    torch.distributed.destroy_process_group()
    timed_phase(phase_graph_native, dev, smi)
    timed_phase(phase_shim, dev)
    timed_phase(phase_examples, dev, smi)
    wl_src, wl_tpu = "pyisingmontecarlo_tpu_torch/csrc/wl.cu", "pyisingmontecarlo_tpu/ops/wl_pallas.py"
    ladder_src, ladder_tpu = ("pyisingmontecarlo_tpu_torch/csrc/ladder.cu",
                              "pyisingmontecarlo_tpu/ops/wl_ladder_pallas.py:157")
    long_src = "pyisingmontecarlo_tpu_torch/csrc/worldline.cuh"
    kernels = [
        dict(name="sq2d_tiled", source="pyisingmontecarlo_tpu_torch/csrc/sq2d.cu",
             replaces="pyisingmontecarlo_tpu/ops/sq2d_pallas.py:159", launches=launches, max_abs_err=err),
        dict(name="wl_tiled (plain sweeps)", source=wl_src, replaces=f"{wl_tpu}:330",
             launches=wl_launches + qmc_tiled_launches, max_abs_err=wl_errs["tiled"]),
        dict(name="wl_tiled (sampling mode)", source=wl_src, replaces=f"{wl_tpu}:346", launches=wl_sample_launches,
             max_abs_err=wl_errs["tiled"]),
        dict(name="wl_site+wl_cluster+wl_accumulate (plain sweeps)", source=wl_src, replaces=f"{wl_tpu}:330",
             launches=long_launches, max_abs_err=wl_errs["multi"]),
        dict(name="wl_site+wl_cluster+wl_accumulate (sampling mode)", source=wl_src, replaces=f"{wl_tpu}:346",
             launches=long_sample_launches, max_abs_err=wl_errs["multi"]),
        dict(name="ladder_site+ladder_cluster", source=ladder_src, replaces=ladder_tpu, launches=ladder_launches,
             max_abs_err=ladder_err),
        dict(name="wl_site+wl_cluster+wl_accumulate at L_tau = 10,240 (plain sweeps; fk_line, 512 threads a line)",
             source=wl_src, replaces=f"{wl_tpu}:330", launches=ll_launches["plain"][0], max_abs_err=long_errs["wl"]),
        dict(name="wl_site+wl_cluster+wl_accumulate at L_tau = 10,240 (sampling mode)", source=wl_src,
             replaces=f"{wl_tpu}:346", launches=ll_launches["sampling"][0], max_abs_err=long_errs["wl"]),
        dict(name="wl_site+fk_long_*+wl_accumulate (plain sweeps; a line past one block, L_tau = 40,960)",
             source=f"{wl_src}, {long_src}", replaces=f"{wl_tpu}:330", launches=sum(ll_launches["long"]),
             max_abs_err=long_errs["wl"]),
        dict(name="wl_site+fk_long_*+wl_accumulate (sampling mode; L_tau = 40,960)", source=f"{wl_src}, {long_src}",
             replaces=f"{wl_tpu}:346", launches=sum(ll_launches["long-sampling"]), max_abs_err=long_errs["wl"]),
        dict(name="ladder_site+ladder_cluster at L_tau = 5120 (fk_line, 512 threads a line)", source=ladder_src,
             replaces=ladder_tpu, launches=llpt_launches["wide"][0], max_abs_err=long_errs["ladder"]),
        dict(name="ladder_site+fk_long_* (a line past one block, L_tau = 250,000)", source=f"{ladder_src}, {long_src}",
             replaces=ladder_tpu, launches=sum(llpt_launches["long"]), max_abs_err=long_errs["ladder"]),
        dict(name=f"fk_long_sums+fk_long_apply (the cluster phase past one block, a sweep's "
                  f"{wl.LONG_LAUNCHES_PER_SWEEP} launches)", source=long_src,
             replaces=f"{wl_tpu}:263 and pyisingmontecarlo_tpu/ops/wl_ladder_pallas.py:246 (cluster_phase, in the "
                      f"kernels at {wl_tpu}:330, :346 and wl_ladder_pallas.py:157)",
             launches=ll_launches["long"][1] + ll_launches["long-sampling"][1] + llpt_launches["long"][1],
             max_abs_err=max(long_errs["wl"], long_errs["ladder"])),
        dict(name="wl_resident (sampling mode)", source=wl_src, replaces=f"{wl_tpu}:346",
             launches=resident_launches + qmc_resident_launches, max_abs_err=wl_errs["resident"]),
        dict(name="ladder_resident", source=ladder_src, replaces=ladder_tpu,
             launches=ladder_res_launches + par_counts["ladder_resident"], max_abs_err=ladder_res_err),
        dict(name="pt_swap_features", source=ladder_src,
             replaces="no Pallas kernel: the XLA ops of pyisingmontecarlo_tpu/tempering.py:152 (_swap_features)",
             launches=feature_launches, max_abs_err=max(ladder_err, long_errs["ladder"])),
        dict(name="threefry_chain", source="pyisingmontecarlo_tpu_torch/csrc/keychain.cu",
             replaces="pyisingmontecarlo_tpu/engines/classical.py:675, engines/worldline.py:396 and "
                      "engines/generic.py:878 (the XLA split_keys chains of time_step and the sweeps; no Pallas kernel)",
             launches=keychain_launches + qmc_keychain_launches + qr_keychain_launches,
             max_abs_err=max(chain_err, qr_chain_err)),
        dict(name="threefry_bits", source="pyisingmontecarlo_tpu_torch/csrc/keychain.cu",
             replaces="pyisingmontecarlo_tpu/parallel/spatial.py:76 and parallel/tau.py:104,117-118 (jax.random.uniform "
                      "inside the sharded XLA sweeps; no Pallas kernel)",
             launches=bits_launches, max_abs_err=bits_err),
    ]
    print(f"seconds by phase: {json.dumps(seconds)}; {sum(seconds.values()):.1f} s in all", flush=True)
    print(json.dumps({"kernels": [dict(k, route="cuda") for k in kernels]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
