"""Transverse-field Ising chain across its quantum critical point Gamma/J = 1:
magnetization-squared vs Gamma at low temperature via worldline QMC.

Twin of ``examples/tfim_quantum_phase_transition.py`` on the port: the same
chain, seed, fields and columns. On the card the worldline kernel
(``csrc/wl.cu``) runs the sweeps, on the route that ``ops/wl.choose_route``
gives the shape.

    python -m pyisingmontecarlo_tpu_torch.examples.tfim_quantum_phase_transition [n_sites] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from pyisingmontecarlo_tpu_torch import Lattice, models

GAMMAS = (0.4, 0.7, 1.0, 1.3, 1.8)


def run(n=16, beta=8.0, gammas=GAMMAS, timesteps=400, replicas=32, sampling_wait_buffer=300, seed=1,
        device="cuda"):
    """``[(Gamma, <m_z^2>, <E>/n, the standard error of <E>/n)]`` of the
    periodic n-site chain (J = -1) at each Gamma: ``replicas`` worldlines,
    ``sampling_wait_buffer`` sweeps, then ``timesteps`` sampled sweeps."""
    rows = []
    for gamma in gammas:
        lat = Lattice(models.chain_edges(n, j=-1.0), seed_gen=seed, device=device)
        lat.set_transverse_field(gamma)
        meas, es = lat.run_quantum_monte_carlo_and_measure_spins(
            beta, timesteps, replicas, sampling_wait_buffer=sampling_wait_buffer, exponent=2)
        rows.append((gamma, meas.mean() / n**2, es.mean() / n, es.std(ddof=1) / np.sqrt(len(es)) / n))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description="TFIM chain: <m_z^2> across Gamma/J = 1")
    ap.add_argument("n_sites", nargs="?", type=int, default=16)
    ap.add_argument("--device", default="cuda", help="cuda (the kernel), or cpu (its plain version)")
    a = ap.parse_args(argv)
    beta = 8.0  # low temperature: probes the ground state
    rows = run(a.n_sites, beta, device=a.device)
    print(f"# TFIM chain n={a.n_sites}, beta={beta}: <m_z^2> collapses past Gamma/J = 1")
    print(f"# {'Gamma':>6} {'<m^2>':>8} {'<E>/n':>8}")
    for gamma, m2, e, _ in rows:
        print(f"  {gamma:6.2f} {m2:8.4f} {e:8.4f}")
    return rows


if __name__ == "__main__":
    main()
