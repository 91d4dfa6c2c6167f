"""Parallel tempering on a 2D +-J Edwards-Anderson spin glass: the beta ladder
finds low-energy states that single-temperature dynamics can't reach.

Twin of ``examples/spin_glass_tempering.py`` on the port: the same glass,
seeds, ladder and lines. On the card the ladder kernel (``csrc/ladder.cu``)
runs the sweeps: ``ladder_resident`` where ``ops/wl.resident_plan`` admits
the shape, else the multi-launch ladder.

    python -m pyisingmontecarlo_tpu_torch.examples.spin_glass_tempering [L] [n_replicas] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from pyisingmontecarlo_tpu_torch import LatticeTempering, models


def run(L=8, nrep=24, thermalize=200, timesteps=400, replica_swap_freq=2, sampling_freq=40, seed=0,
        device="cuda"):
    """The L x L +-J glass (couplings from seed 0) on a ladder of ``nrep``
    rungs, beta from 0.3 to 3.0 geometrically, Gamma = 0.5: ``thermalize``
    sweeps, then ``timesteps`` with swaps and samples. Returns a dict:
    ``swaps`` (accepted), ``energies`` (<E> of each rung, hottest first),
    ``bonds`` and ``coldest_m`` (|m| of the coldest rung's samples)."""
    edges = models.pm_j_spin_glass_edges(L, seed=0)
    lt = LatticeTempering(edges, seed=seed, device=device)
    for b in np.geomspace(0.3, 3.0, nrep):
        lt.add_graph(0.5, 0.0, float(b))
    lt.qmc_timesteps(thermalize)
    states, energies = lt.qmc_timesteps_sample(timesteps, replica_swap_freq=replica_swap_freq,
                                               sampling_freq=sampling_freq)
    m = np.where(states[-1], 1, -1)
    return dict(swaps=lt.get_total_swaps(), energies=energies, bonds=len(edges), coldest_m=abs(m.mean()))


def main(argv=None):
    ap = argparse.ArgumentParser(description="parallel tempering on a 2D +-J spin glass")
    ap.add_argument("L", nargs="?", type=int, default=8)
    ap.add_argument("n_replicas", nargs="?", type=int, default=24)
    ap.add_argument("--device", default="cuda", help="cuda (the kernel), or cpu (its plain version)")
    a = ap.parse_args(argv)
    out = run(a.L, a.n_replicas, device=a.device)
    print(f"# {a.L}x{a.L} +-J glass, {a.n_replicas}-rung ladder")
    print(f"accepted swaps: {out['swaps']}")
    print(f"coldest-rung <E>: {out['energies'][-1]:.2f}  ({out['bonds']} bonds)")
    print(f"coldest-rung |m|: {out['coldest_m']:.3f} (glass: should stay small)")
    return out


if __name__ == "__main__":
    main()
