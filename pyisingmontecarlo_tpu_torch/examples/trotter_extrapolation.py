"""Richardson extrapolation of the Trotter bias.

Twin of ``examples/trotter_extrapolation.py`` on the port. The worldline
engines carry an O(dtau^2) discretization bias. Two runs at dtau and dtau/2
cancel the leading term:

    E_extrap = (4 * E(dtau/2) - E(dtau)) / 3

on a 4-site TFIM ring, whose exact energy dense diagonalization gives; each
raw run's bias and the extrapolation's are printed with propagated error bars
(se = sqrt(16 se_half^2 + se_full^2) / 3). On the card ``QmcIsing`` runs the
worldline kernel (``csrc/wl.cu``) where its gate admits the ring, else the
generic worldline engine.

    python -m pyisingmontecarlo_tpu_torch.examples.trotter_extrapolation [dtau] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np

from pyisingmontecarlo_tpu_torch import QmcIsing, models


def exact_energy(n, gamma, beta):
    """Dense-diagonalization <E> of the TFIM ring (J = -1)."""
    dim = 2**n
    H = np.zeros((dim, dim))
    for i in range(n):
        jn = (i + 1) % n
        for a in range(dim):
            za = 1.0 if (a >> i) & 1 else -1.0
            zb = 1.0 if (a >> jn) & 1 else -1.0
            H[a, a] += -1.0 * za * zb
            H[a ^ (1 << i), a] += -gamma
    w, _ = np.linalg.eigh(H)
    p = np.exp(-beta * (w - w.min()))
    return float((w * p).sum() / p.sum())


def measure(n, gamma, beta, dtau, timesteps=600, replicas=256, seed=7, equilibrate=150, device="cuda"):
    """(<E>, its standard error) of ``replicas`` worldlines at Trotter step
    ``dtau``: ``equilibrate`` sweeps, then ``timesteps`` sampled sweeps."""
    q = QmcIsing(models.chain_edges(n, j=-1.0), gamma, num_experiments=replicas, seed=seed, dtau=dtau,
                 device=device)
    q.run_qmc(beta, equilibrate)
    es, _ = q.run_sampling(beta, timesteps, sampling_wait_buffer=0)
    return float(es.mean()), float(es.std(ddof=1) / np.sqrt(len(es)))


def run(dtau=0.2, n=4, gamma=1.0, beta=2.0, timesteps=600, replicas=256, equilibrate=150, device="cuda"):
    """(exact <E>, ``[(label, <E>, stderr, bias)]`` for the run at ``dtau``
    (seed 7), the run at ``dtau / 2`` (seed 8) and their Richardson
    combination)."""
    ex = exact_energy(n, gamma, beta)
    kw = dict(timesteps=timesteps, replicas=replicas, equilibrate=equilibrate, device=device)
    e_full, se_full = measure(n, gamma, beta, dtau, seed=7, **kw)
    e_half, se_half = measure(n, gamma, beta, dtau / 2, seed=8, **kw)
    e_x = (4.0 * e_half - e_full) / 3.0
    se_x = np.sqrt(16.0 * se_half**2 + se_full**2) / 3.0
    rows = [("dtau=" + format(dtau, ".3f"), e_full, se_full), ("dtau=" + format(dtau / 2, ".3f"), e_half, se_half),
            ("Richardson", e_x, se_x)]
    return ex, [(label, e, se, e - ex) for label, e, se in rows]


def main(argv=None):
    ap = argparse.ArgumentParser(description="Richardson extrapolation of the Trotter bias")
    ap.add_argument("dtau", nargs="?", type=float, default=0.2)
    ap.add_argument("--device", default="cuda", help="cuda (the kernel), or cpu (its plain version)")
    a = ap.parse_args(argv)
    n, gamma, beta = 4, 1.0, 2.0
    ex, rows = run(a.dtau, n, gamma, beta, device=a.device)
    print(f"# TFIM ring n={n} Gamma={gamma} beta={beta}: exact <E> = {ex:.5f}")
    print(f"# {'run':>14} {'<E>':>9} {'stderr':>8} {'bias':>9}")
    for label, e, se, bias in rows:
        print(f"  {label:>14} {e:9.5f} {se:8.5f} {bias:9.5f}")
    print("# the combination cancels the leading O(dtau^2) term: its bias")
    print("# should sit inside its error bar while the coarse run's does not")
    return ex, rows


if __name__ == "__main__":
    main()
