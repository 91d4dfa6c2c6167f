"""``Lattice.run_monte_carlo`` on a periodic square torus with uniform
coupling: one call a step of the closed loop, the beta of call i
``betas[i % len(betas)]``.

Configuration keys: ``side``, ``j``, ``h``. Parameters: ``timesteps``,
``num_experiments``, ``betas``, ``check_replicas`` (how many of the window's
(call, replica) outputs the reference follows).

Each call keeps one of its replicas with its energy and state: call i one
drawn from the seed in stratum ``i mod check_replicas`` of the replica axis
(``check_replicas`` equal slices). After the window one kept output of each
stratum, the call drawn from the seed, is worked out again by
``reference/glauber2d.py`` from the master stream (the program's seeds of
every call in order), at the call's own sweeps and lattice: the states and
the energies must be equal. So every slice of the batch is checked, and a
fault in any half of it shows.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.reference import glauber2d, inputs
from portbench.reference import threefry as tf


class Judge:
    """The cell's inputs and the judgement of kept outputs, without the program."""

    def __init__(self, config: dict, params: dict, seed: int, device: str):
        self.L, self.j, self.h = int(config["side"]), float(config["j"]), float(config["h"])
        self.T, self.R = int(params["timesteps"]), int(params["num_experiments"])
        self.betas = [float(b) for b in params["betas"]]
        self.n_check = int(params["check_replicas"])
        self.seed, self.device = int(seed), device
        self.pick = np.random.default_rng([self.seed, 1])
        self.calls = 0  # calls made of the program, warm-up included: the master stream's position
        self.kept = []  # (call, beta, replica, energy, packed state) a window call

    def _replica(self) -> int:
        """The replica call ``self.calls`` keeps: drawn from the seed in its stratum."""
        k = self.calls % self.n_check
        lo, hi = k * self.R // self.n_check, (k + 1) * self.R // self.n_check
        return int(self.pick.integers(lo, max(hi, lo + 1)))

    def keep(self, es, ss) -> None:
        """Keep one replica of the call just made."""
        r = self._replica()
        self.kept.append((self.calls, self.betas[self.calls % len(self.betas)], r, float(es[r]), np.packbits(ss[r])))

    def reference(self, chosen, ftype=torch.float32):
        """``(states [n, L*L] bool, energies [n])`` of the kept outputs
        ``chosen`` worked out again, the thresholds in ``ftype``."""
        gen = np.random.Generator(np.random.PCG64(self.seed))
        want = {c[0]: c for c in chosen}
        seeds = {}
        for call in range(max(want) + 1):
            s = tf.master_seeds(gen, self.R)
            if call in want:
                seeds[call] = s[want[call][2]]
        k = torch.from_numpy(tf.kernel_seeds(tf.keys_of([seeds[c[0]] for c in chosen]))).to(self.device)
        E, O = glauber2d.initial_states(k, self.L)
        thr = glauber2d.thresholds([c[1] for c in chosen], self.j, self.h, ftype)
        E, O = glauber2d.sweeps(E, O, k, thr, self.T)
        s = glauber2d.unpack(E, O)
        return (s == 1).reshape(len(chosen), -1).cpu().numpy(), glauber2d.energies(s, self.j, self.h)

    def chosen(self) -> list:
        """One kept output of each stratum, the call drawn from the seed."""
        pick = np.random.default_rng([self.seed, 2])
        out = []
        for k in range(self.n_check):
            same = [c for c in self.kept if c[0] % self.n_check == k]
            if same:
                out.append(same[int(pick.integers(len(same)))])
        return sorted(out)

    def check(self) -> list:
        """``[(name, value, limit)]``: spins and energies of the chosen
        outputs that differ from the reference's."""
        chosen = self.chosen()
        if not chosen:
            return [("outputs", 0, -1)]
        states, energies = self.reference(chosen)
        got = np.stack([np.unpackbits(c[4])[: self.L * self.L].astype(bool) for c in chosen])
        return [("spins_differ", int((got != states).sum()), 0),
                ("energies_differ", int((np.array([c[3] for c in chosen]) != energies).sum()), 0)]

    def control(self, ftype, calls: int) -> None:
        """The outputs the check would judge after ``calls`` window calls
        that follow one warm-up call, as the reference computes them with its
        thresholds in ``ftype``: the control, in the program's place."""
        self.calls = 1
        for _ in range(calls):
            self.kept.append((self.calls, self.betas[self.calls % len(self.betas)], self._replica(), None, None))
            self.calls += 1
        chosen = self.chosen()
        states, energies = self.reference(chosen, ftype)
        self.kept = [(c, b, r, float(e), np.packbits(st)) for (c, b, r, _, _), e, st in zip(chosen, energies, states)]


class Driver(Judge):
    WITNESS = (("sq2d_tiled", "sweeps_2d.launches"),)

    def __init__(self, config: dict, params: dict, seed: int, device: str):
        from pyisingmontecarlo_tpu_torch import Lattice

        super().__init__(config, params, seed, device)
        a, b = inputs.torus_edges(self.L)
        self.lat = Lattice(inputs.edge_list(a, b, self.j), seed_gen=self.seed, device=device)
        self.lat.set_global_bias(self.h)

    def _call(self, keep: bool) -> dict:
        es, ss = self.lat.run_monte_carlo(self.betas[self.calls % len(self.betas)], self.T, self.R)
        if keep:
            self.keep(es, ss)
        self.calls += 1
        return {"updates": self.R * self.L * self.L * self.T, "sweeps": self.T}

    def warm(self) -> None:
        self._call(keep=False)

    def call(self) -> dict:
        return self._call(keep=True)

    def counters(self) -> dict:
        from pyisingmontecarlo_tpu_torch.ops import sq2d

        return {"sweeps_2d.launches": sq2d.sweeps_2d.launches}

    def info(self) -> dict:
        return {"R": self.R, "L": self.L, "T": self.T}

    def release(self) -> None:
        self.lat = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()
