"""Magnetization curve of the 2D Ising ferromagnet across the transition,
compared against Onsager's exact result.

Twin of ``examples/ferromagnet_phase_diagram.py`` on the port: the same
model, seed, betas and columns. On the card the square-torus kernel
(``csrc/sq2d.cu``, ``sq2d_tiled`` in its sampling mode) runs every sweep.

    python -m pyisingmontecarlo_tpu_torch.examples.ferromagnet_phase_diagram [L] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from pyisingmontecarlo_tpu_torch import Lattice, models

BETA_C = 0.44068679350977147
BETAS = (0.30, 0.38, 0.42, 0.44, 0.46, 0.50, 0.60)


def onsager_m(beta):
    if beta <= BETA_C:
        return 0.0
    return (1.0 - np.sinh(2.0 * beta) ** -4) ** 0.125


def run(L=32, betas=BETAS, timesteps=200, replicas=32, thermalization_time=2000, sampling_freq=20, seed=0,
        device="cuda"):
    """``[(beta, <|m|>, its standard error, Onsager's m)]``: at each beta,
    ``replicas`` runs from a random start on the L x L torus (J = -1), the
    magnetization sampled every ``sampling_freq`` of ``timesteps`` sweeps
    after ``thermalization_time``."""
    lat = Lattice(models.square_edges(L, j=-1.0), seed_gen=seed, device=device)
    rows = []
    for beta in betas:
        _, ss = lat.run_monte_carlo_sampling(beta, timesteps, replicas, thermalization_time=thermalization_time,
                                             sampling_freq=sampling_freq)
        m = np.abs(np.where(ss, 1.0, -1.0).mean(axis=2))
        rows.append((beta, m.mean(), m.std(ddof=1) / np.sqrt(m.size), onsager_m(beta)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="2D Ising ferromagnet: <|m|> against Onsager")
    ap.add_argument("L", nargs="?", type=int, default=32)
    ap.add_argument("--device", default="cuda", help="cuda (the kernel), or cpu (its plain version)")
    a = ap.parse_args(argv)
    rows = run(a.L, device=a.device)
    print(f"# 2D Ising ferromagnet {a.L}x{a.L}: <|m|> vs Onsager")
    print(f"# {'beta':>6} {'<|m|>':>8} {'stderr':>8} {'onsager':>8}")
    for beta, m, se, exact in rows:
        print(f"  {beta:6.2f} {m:8.4f} {se:8.4f} {exact:8.4f}")
    return rows


if __name__ == "__main__":
    main()
