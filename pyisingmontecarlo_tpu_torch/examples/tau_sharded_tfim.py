"""Imaginary-time sharding: one TFIM worldline split across ranks.

Twin of ``examples/tau_sharded_tfim.py`` on the port. At large beta * Gamma
the worldline tensor [replicas, nvars, L_tau] outgrows one device; its tau
axis then shards over a mesh like any spatial axis. Each rank owns a tau
slab, trades one boundary slice a direction with its ring neighbours
(``parallel/comm.ring_shift``) and runs the dense update composition on its
slab; FK clusters build on the open local window with shard-parity
alternation (``pyisingmontecarlo_tpu_torch/parallel/tau.py``).

    python -m pyisingmontecarlo_tpu_torch.examples.tau_sharded_tfim --device cpu     # 8 ranks, gloo, CPU
    python -m pyisingmontecarlo_tpu_torch.examples.tau_sharded_tfim --ranks 2        # NCCL, a GPU a rank

(the second needs a GPU a rank).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from pyisingmontecarlo_tpu_torch.engines import classical as ce
from pyisingmontecarlo_tpu_torch.engines import worldline as wl
from pyisingmontecarlo_tpu_torch.entry import launch, on_mesh
from pyisingmontecarlo_tpu_torch.graph import compile_graph
from pyisingmontecarlo_tpu_torch.parallel import tau as pt
from pyisingmontecarlo_tpu_torch.parallel.tau import bernoulli_states


def run(mesh, nvars=16, ltau=64, replicas=128, beta=2.0, gamma=1.0, steps=6, sweeps=20):
    """The example on this rank's mesh: ``steps`` calls of ``sweeps`` tau-sharded
    sweeps from key (0, step + 1), a random start from key 0. Returns
    ``[(sweeps so far, <E>, its standard error)]`` and the final state's
    shape, the same on every rank."""
    edges = [((i, (i + 1) % nvars), -1.0) for i in range(nvars)]
    s = bernoulli_states([0, 0], (replicas, nvars, ltau))
    ga = ce.device_graph(compile_graph(edges))
    p = wl.make_params(np.full(replicas, beta), gamma, 0.0, ltau)
    out = []
    for step in range(steps):
        s = pt.sharded_wl_sweeps(s, np.array([0, step + 1], np.uint32), mesh, beta, gamma, -1.0, 0.0, sweeps=sweeps)
        e = wl.total_energy(ga, p, s.cpu()).numpy().astype(np.float64)
        out.append((sweeps * (step + 1), e.mean(), e.std(ddof=1) / np.sqrt(replicas)))
    return out, tuple(s.shape)


def main(argv=None):
    ap = argparse.ArgumentParser(description="tau-sharded TFIM worldline")
    ap.add_argument("--ranks", type=int, default=8, help="tau slabs, one a rank")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda, gloo on the cpu")
    ap.add_argument("--device", default="cuda", help="cuda (one GPU a rank), or cpu")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--sweeps", type=int, default=20)
    a = ap.parse_args(argv)
    n = a.ranks
    energies, shape = launch(on_mesh, n, a.backend, a.device, timeout=1800.0, args=((n,), ("tau",), run),
                             kwargs=dict(device=a.device, steps=a.steps, sweeps=a.sweeps))[0]
    for done, mean, se in energies:
        print(f"after {done:3d} sweeps: <E> = {mean:8.4f} +- {se:.4f}")
    print(f"state {shape}: {n} tau slabs of {shape[2] // n} slices, one a rank ({a.device})")
    return energies


if __name__ == "__main__":
    torch.set_num_threads(1)
    main()
