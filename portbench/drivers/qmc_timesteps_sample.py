"""``LatticeTempering.qmc_timesteps_sample`` on one ladder that persists
across calls: rungs at betas spaced evenly in log, one transverse field, a
+-J glass on a periodic square torus, a swap step every
``replica_swap_freq`` sweeps and a sample every sweep.

Configuration keys: ``side``, ``gamma``, ``h``, ``dtau``, ``ltau``,
``beta_min``, ``beta_max``, ``rungs``. Parameters: ``timesteps`` (a call's
sweeps), ``replica_swap_freq``, ``warm_timesteps`` (the set-up's call),
``check_sweeps`` (the sweeps of the window's first call the reference
follows).

The set-up drives the ladder from the seed through a first call of
``warm_timesteps`` sweeps, through the window's own entry, and hands the same
object to the window. ``reference/tempering.py`` follows the ladder from the
seed: that first call whole (its samples, energies, accepted swaps and final
worldlines) and the first ``check_sweeps`` sweeps of the window's first call
(their samples). Each must be equal.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from portbench.reference import inputs, tempering


class Judge:
    """The cell's inputs and the judgement of kept outputs, without the program."""

    def __init__(self, config: dict, params: dict, seed: int, device: str):
        c = config
        self.side, self.gamma, self.h = int(c["side"]), float(c["gamma"]), float(c["h"])
        self.ltau, self.nvars = int(c["ltau"]), int(c["side"]) ** 2
        self.betas = inputs.beta_ladder(c["beta_min"], c["beta_max"], c["rungs"])
        self.R = len(self.betas)
        self.T, self.sf = int(params["timesteps"]), int(params["replica_swap_freq"])
        self.warm_T, self.check_T = int(params["warm_timesteps"]), int(params["check_sweeps"])
        self.seed, self.device = int(seed), device
        self.ea, self.eb = inputs.torus_edges(self.side)
        self.ej = inputs.pm_j(self.seed, len(self.ea))
        self.first = self.window_first = None

    def ladder(self, ftype=torch.float32):
        return tempering.Ladder(self.side, self.ea, self.eb, self.ej, self.betas, self.gamma, self.h, self.ltau,
                                self.seed, self.device, ftype)

    def check(self) -> list:
        """``[(name, value, limit)]``: what differs from the reference."""
        ref = self.ladder()
        states, energies, swaps, wl = self.first
        rs, re, _ = ref.call(self.warm_T)
        out = [("warm.samples", int((states != rs).sum()), 0),
               ("warm.energies", int((energies != re).sum()), 0),
               ("warm.swaps", abs(swaps - ref.total_swaps), 0),
               ("warm.worldlines", int((wl != ref.worldlines()).sum()), 0)]
        if self.window_first is None:
            return out + [("window.calls", 0, -1)]
        rs, _, _ = ref.call(self.T, upto=self.check_T)
        return out + [("window.samples", int((self.window_first[:, : rs.shape[1]] != rs).sum()), 0)]

    def control(self, ftype) -> None:
        """The set-up's call and the window's first call as the reference
        computes them in ``ftype``: the control, in the program's place."""
        lad = self.ladder(ftype)
        states, energies, _ = lad.call(self.warm_T)
        self.first = (states, energies, lad.total_swaps, lad.worldlines())
        self.window_first = lad.call(self.T, upto=self.check_T)[0]


class Driver(Judge):
    WITNESS = (("ladder_", "ladder_sweeps.launches"),)

    def __init__(self, config: dict, params: dict, seed: int, device: str):
        from pyisingmontecarlo_tpu_torch import LatticeTempering

        super().__init__(config, params, seed, device)
        self.lt = LatticeTempering(inputs.edge_list(self.ea, self.eb, self.ej), seed=self.seed,
                                   dtau=float(config["dtau"]), device=device)
        for b in self.betas:
            self.lt.add_graph(self.gamma, self.h, float(b))
        self.steps = 0  # swap steps made, warm-up included: their parities alternate from 0

    def _attempts(self, T: int) -> int:
        """Pairs a call of ``T`` sweeps attempts: a step of parity p pairs the
        rungs r = p, p + 2, ... below the last."""
        n = 0
        for _ in range(T // self.sf):
            n += len(range(self.steps % 2, self.R - 1, 2))
            self.steps += 1
        return n

    def warm(self) -> None:
        states, energies = self.lt.qmc_timesteps_sample(self.warm_T, replica_swap_freq=self.sf)
        self._attempts(self.warm_T)
        wl = np.stack([self.lt.get_graph_itime(g) for g in range(self.R)])
        self.first = (states, energies, self.lt.get_total_swaps(), wl)

    def call(self) -> dict:
        states, _ = self.lt.qmc_timesteps_sample(self.T, replica_swap_freq=self.sf)
        if self.window_first is None:
            self.window_first = states
        return {"sweeps": self.T, "swaps": self._attempts(self.T), "updates": self.R * self.nvars * self.ltau * self.T}

    def counters(self) -> dict:
        from pyisingmontecarlo_tpu_torch.ops import ladder

        return {"ladder_sweeps.launches": ladder.ladder_sweeps.launches}

    def info(self) -> dict:
        """Shapes, and the cluster heads a sweep expected of the current
        state: a bond is frozen when its slices align, with probability
        p_bond of the rung, so a head follows each other bond."""
        wl = torch.from_numpy(np.stack([self.lt.get_graph_itime(g) for g in range(self.R)]))
        aligned = (wl == wl.roll(-1, 1)).sum((1, 2)).numpy().astype(np.float64)
        dt = self.betas / self.ltau
        pb = 1.0 - np.tanh(dt * self.gamma)  # 1 - exp(-2 Ktau) with Ktau = -log(tanh(dt Gamma)) / 2
        heads = float((self.nvars * self.ltau - aligned * pb).sum())
        return {"R": self.R, "nvars": self.nvars, "L": self.ltau, "heads_per_sweep": heads}

    def release(self) -> None:
        self.lt = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.empty_cache()
