"""``Lattice.run_quantum_monte_carlo`` on a periodic square torus with
uniform coupling in a transverse field: one call a step of the closed loop,
each call a fresh ensemble of ``num_experiments`` replicas, as the entry
makes.

Configuration keys: ``side``, ``j``, ``h``, ``gamma``, ``dtau``, ``ltau``
(the slices the program's rule gives at the traffic's beta). Parameters:
``timesteps``, ``num_experiments``, ``beta``, ``check_replicas`` (how many
of the window's (call, replica) outputs the reference follows).

The outputs are kept and judged as ``run_monte_carlo.py`` keeps and judges
them: call i keeps one replica's energy and slice-0 state, drawn from the
seed in stratum ``i mod check_replicas`` of the replica axis, and after the
window one kept output of each stratum is worked out again by
``reference/worldline.py`` from the master stream; the states and the
energies must be equal.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from portbench.core import load_module
from portbench.reference import inputs, worldline
from portbench.reference import threefry as tf

_torus = load_module("drivers", "run_monte_carlo")


class Judge(_torus.Judge):
    """The cell's inputs and the judgement of kept outputs, without the program."""

    def __init__(self, config: dict, params: dict, seed: int, device: str):
        super().__init__(config, dict(params, betas=[params["beta"]]), seed, device)
        self.beta = float(params["beta"])
        self.gamma, self.dtau, self.ltau = float(config["gamma"]), float(config["dtau"]), int(config["ltau"])
        self.nvars = self.L * self.L

    def reference(self, chosen, ftype=torch.float32):
        """``(states [n, nvars] bool, energies [n])`` of the kept outputs
        ``chosen`` worked out again, the f32 parts of the rule in ``ftype``."""
        gen = np.random.Generator(np.random.PCG64(self.seed))
        want = {c[0]: c[2] for c in chosen}
        seeds = {}
        for call in range(max(want) + 1):
            s = tf.master_seeds(gen, self.R)
            if call in want:
                seeds[call] = s[want[call]]
        return worldline.run(np.array([seeds[c[0]] for c in chosen], np.uint64), self.L, self.j, self.h,
                             self.gamma, self.beta, self.ltau, self.T, self.device, ftype)


class Driver(Judge):
    WITNESS = (("wl_tiled", "wl_sweeps.tiled_launches"),)

    def __init__(self, config: dict, params: dict, seed: int, device: str):
        from pyisingmontecarlo_tpu_torch import Lattice

        super().__init__(config, params, seed, device)
        a, b = inputs.torus_edges(self.L)
        self.lat = Lattice(inputs.edge_list(a, b, self.j), seed_gen=self.seed, dtau=self.dtau, device=device)
        self.lat.set_global_bias(self.h)
        self.lat.set_transverse_field(self.gamma)

    def _call(self, keep: bool) -> dict:
        es, ss = self.lat.run_quantum_monte_carlo(self.beta, self.T, self.R)
        if keep:
            self.keep(es, ss)
        self.calls += 1
        return {"updates": self.R * self.nvars * self.ltau * self.T, "sweeps": self.T}

    def warm(self) -> None:
        self._call(keep=False)

    def call(self) -> dict:
        return self._call(keep=True)

    def counters(self) -> dict:
        from pyisingmontecarlo_tpu_torch.ops import wl

        return {"wl_sweeps.tiled_launches": wl.wl_sweeps.tiled_launches}

    def info(self) -> dict:
        """Shapes, and the cluster heads a sweep expected of worldlines whose
        time bonds all align: each bond stays unfrozen with probability
        ``1 - p_bond = tanh(dtau Gamma)`` and heads a cluster. A kink adds a
        head, so this is the fewest a sweep can have."""
        heads = self.R * self.nvars * self.ltau * math.tanh(self.beta / self.ltau * self.gamma)
        return {"R": self.R, "nvars": self.nvars, "L": self.ltau, "T": self.T, "heads_per_sweep": heads}

    def release(self) -> None:
        self.lat = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()
