"""``LatticeTempering`` — parallel tempering over TFIM worldlines, on torch.

Counterpart of ``pyisingmontecarlo_tpu/tempering.py``: replicas at
per-replica (beta, Gamma, h), optionally with their own couplings on a union
graph, sweep together, with an even/odd neighbour swap every
``replica_swap_freq`` sweeps. Two routes, as in the JAX package:

- the **ladder route**, where the union graph is a periodic ring or square
  torus that ``ops/ladder.gate`` admits and no replica has the RVB move: the
  ladder kernel (``ops/ladder.py``, one kernel call per run of sweeps between
  two swap steps);
- the **generic route** for every other ladder: the generic colored worldline
  sweep of ``engines/worldline.py`` with the per-replica couplings ``[R, E]``
  on the union graph's colorings (``batched_graph_arrays``), and the RVB
  phases masked to the replicas that ask for them.

A swap step weighs every replica's configuration under its own and its
neighbours' parameters from three exact integer features of each
configuration (``ops/ladder.swap_features``: per-edge bond products, spin
sum, aligned time bonds; the ladder call returns them as int32, from the
resident kernel itself or from ``pt_swap_features`` after the multi-launch
route's last sweep; the generic route computes them from the state), in f32
as the JAX package does, and accepts pair (r, r+1), r of
the step's parity, when ``log u < W_r(x_{r+1}) W_{r+1}(x_r) / (W_r(x_r)
W_{r+1}(x_{r+1}))`` in log space; accepted pairs exchange configurations.
On the ladder route the energies use the same features, accumulated per
replica slot as int64 on the device; the estimator is linear in them, so it
is formed once per call on the host in f64. The generic route accumulates
``worldline.total_energy`` after every sweep in a compensated f32 pair, as
the JAX package does.

Randomness, bit for bit the JAX package's: on the ladder route each
replica's threefry key is split once per sweep and the subkey gives that
sweep's kernel seed; on the generic route once per phase of the sweep
(``worldline.walk`` on ``rng.threefry_chain``). The swap key is split once
per swap step and the subkey gives ``uniform(sub, (R,))``. A call makes its
seeds and uniforms before its first sweep, on the ladder's device
(``key_tables_device``, ``swap_uniforms_device``: ``rng.threefry_chain``
with a plain slot a sweep and a uniform slot a swap step, one launch each on
CUDA); ``key_tables`` and ``swap_uniforms`` are the same tables in numpy, and
make them for a ladder of more rungs than a uniform slot holds.

``enable_heatbath_update`` is accepted and has no effect, as in the JAX
package (every parallel phase accepts by Glauber).

Under a replica shard (``parallel/tempering.shard_ladder``) each rank sweeps
its block of the replicas (the ladder kernel once per rank on them, or the
generic sweep); a swap step gathers the swap features, every rank takes the
same decisions from the same uniforms, and a pair that straddles two blocks
trades its planes with the neighbouring rank. Results are gathered, the same
on every rank, and equal the unsharded run's bit for bit.

Checkpoints are the JAX package's CBOR files (``utils/cbor.py``); the
per-replica seeds are not saved, so a reload reseeds.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ._kernels import resolve_device
from .engines import classical as ce
from .engines import worldline as wl
from .engines.observables import autocorrelation_device, pad_autocorr
from .engines.worldline import choose_ltau, make_params
from .graph import CompiledGraph, compile_graph_arrays, detect_topology, parse_edges
from .ops import ladder
from .ops.ladder import swap_features
from .rng import (_MAX_M, KEY_PLAIN, KEY_UNIFORM, MasterRng, key_data_from_seeds, key_data_of, key_tensor,
                  random_states, seeds_from_key_data, split_all, threefry_chain, uniform_f32)
from .utils import cbor
from .utils.accum import kadd, kfinal, kzero
from .utils.profiling import span

__all__ = ["LatticeTempering", "key_tables", "swap_uniforms", "key_tables_device", "swap_uniforms_device",
           "swap_features", "batched_graph_arrays"]

_NEVER = 2**31 - 1  # the swap period of runs without swaps


def key_tables(key_data: np.ndarray, swapkey: np.ndarray, timesteps: int, swap_freq: int,
               R: Optional[int] = None):
    """The host tables of a call of ``timesteps`` sweeps with a swap every
    ``swap_freq``: ``(seeds [T, len(key_data)] int32, uniforms [T //
    swap_freq, R] f32, key_data, swapkey)`` with the keys advanced past the
    call; ``R`` (the ladder's replicas) defaults to ``len(key_data)``."""
    kd = np.asarray(key_data, np.uint32)
    seeds = np.empty((timesteps, kd.shape[0]), np.int32)
    for t in range(timesteps):
        kd, sub = split_all(kd)
        seeds[t] = seeds_from_key_data(sub)
    uniforms, sk = swap_uniforms(swapkey, timesteps // swap_freq, kd.shape[0] if R is None else R)
    return seeds, uniforms, kd, sk


def swap_uniforms(swapkey: np.ndarray, nswaps: int, R: int):
    """``(uniforms [nswaps, R] f32, swapkey)``: the swap key split once per
    swap step, each subkey giving ``uniform(sub, (R,))``."""
    sk = np.asarray(swapkey, np.uint32).reshape(1, 2)
    uniforms = np.empty((nswaps, R), np.float32)
    for k in range(nswaps):
        sk, sub = split_all(sk)
        uniforms[k] = uniform_f32(sub, R)[0]
    return uniforms, sk[0]


def key_tables_device(keys: torch.Tensor, swapkey: torch.Tensor, timesteps: int, swap_freq: int,
                      R: Optional[int] = None):
    """``key_tables`` on key tensors (the bits of ``rng.key_tensor``: ``keys
    [n, 2]``, ``swapkey [2]``), made on their device: ``(seeds [T, n] int32,
    uniforms [T // swap_freq, R] f32, keys, swapkey)``, the same bits. The
    seeds are ``rng.threefry_chain`` of one plain slot a sweep: one launch on
    CUDA, its numpy version on the CPU. A call on CUDA is counted in
    ``key_tables_device.launches``."""
    seeds, _, keys = threefry_chain(keys, [KEY_PLAIN], int(timesteps), 0)
    uniforms, swapkey = swap_uniforms_device(swapkey, int(timesteps) // int(swap_freq),
                                             keys.shape[0] if R is None else R)
    if keys.device.type == "cuda":
        key_tables_device.launches += 1
    return seeds[:, 0], uniforms, keys, swapkey


key_tables_device.launches = 0


def swap_uniforms_device(swapkey: torch.Tensor, nswaps: int, R: int):
    """``swap_uniforms`` on a key tensor ``swapkey [2]``, made on its device:
    ``(uniforms [nswaps, R] f32, swapkey)``, ``rng.threefry_chain`` of one
    ``(KEY_UNIFORM, R)`` slot a swap step (R at most ``rng._MAX_M``)."""
    _, v0, swapkey = threefry_chain(swapkey.reshape(1, 2), [(KEY_UNIFORM, int(R))], int(nswaps), 0)
    return v0.view(torch.float32)[:, :, 0], swapkey[0]


def batched_graph_arrays(cg: CompiledGraph, jvals: np.ndarray, device="cpu") -> ce.GraphArrays:
    """``classical.GraphArrays`` of the union topology ``cg`` with the
    per-replica couplings ``jvals [R, nedges]`` on every coupling field (a
    leading replica axis), the JAX package's ``batched_graph_arrays``. The
    pair flips use the union's strong edge classes, which are strong for every
    replica's overlay too."""
    jm = np.zeros((jvals.shape[0], cg.nvars, cg.max_deg))
    jm[:, cg.edge_a, cg.edge_slot_a] = jvals
    jm[:, cg.edge_b, cg.edge_slot_b] = jvals
    return ce._assemble(cg.neighbors, jm, cg.degree, cg.edge_a, cg.edge_b, jvals, cg.color_sites,
                        cg.strong_ecolor_edges, ce._slot_eid_np(cg), device)


class LatticeTempering:
    """Parallel-tempering container over worldline TFIM simulators.

    ``LatticeTempering(edges, seed=None, use_allocator=True, *, dtau=None,
    device="cuda")``: the JAX package's constructor, with the device
    explicit (``device="cuda"`` raises where there is no CUDA; ``"cpu"`` runs
    the kernel's plain version). ``cutoff = nvars`` and ``use_allocator`` are
    kept as attributes."""

    def __init__(self, edges: Sequence, seed: Optional[int] = None, use_allocator: bool = True, *,
                 dtau: Optional[float] = None, device="cuda"):
        self.device = resolve_device(device)
        self.edges = [((int(a), int(b)), float(j)) for (a, b), j in edges]
        self.nvars, _, _, _ = parse_edges(self.edges)
        self.cutoff = self.nvars
        self.seed = seed
        self.rng = MasterRng(seed)
        self.use_allocator = bool(use_allocator)
        self.dtau = dtau
        self.graphs = []  # per-replica dicts
        self._edge_index = {}  # (a, b) -> union edge id
        for (a, b), _ in self.edges:
            self._edge_index.setdefault((min(a, b), max(a, b)), len(self._edge_index))
        self.total_swaps = 0
        self._mat = None  # materialized ladder (dict)
        self._swapkey = None  # [2] uint32 key data
        self._restored = None  # [R, nvars, L] int8 states from a checkpoint

    # ---------------------------------------------------------------- ladder

    def add_graph(self, transverse: float, longitudinal: float, beta: float, edges: Optional[Sequence] = None,
                  enable_rvb_update: bool = False, enable_heatbath_update: bool = False,
                  seed: Optional[int] = None, use_allocator: Optional[bool] = None) -> None:
        """Append a replica with its own Hamiltonian and beta; ``edges``
        overrides the couplings (edges may be new to the union graph)."""
        transverse = float(transverse)
        if transverse <= 0:
            raise ValueError("Transverse field must be positive for QMC")
        if edges is not None:
            own = [((int(a), int(b)), float(j)) for (a, b), j in edges]
            for (a, b), _ in own:
                if a >= self.nvars or b >= self.nvars or a < 0:
                    raise ValueError(f"Edge ({a},{b}) out of bounds (nvars={self.nvars})")
                self._edge_index.setdefault((min(a, b), max(a, b)), len(self._edge_index))
        else:
            own = self.edges
        g_seed = int(seed) if seed is not None else self.rng.next_seed()
        self.graphs.append(dict(transverse=transverse, longitudinal=float(longitudinal), beta=float(beta),
                                edges=own, rvb=bool(enable_rvb_update), heatbath=bool(enable_heatbath_update),
                                seed=g_seed))
        self._mat = None  # materialize anew

    def get_num_graphs(self) -> int:
        return len(self.graphs)

    def get_total_swaps(self) -> int:
        """Accepted swaps, over the container's life."""
        return int(self.total_swaps)

    # --------------------------------------------------------- materialization

    def _union_jvals(self) -> np.ndarray:
        jv = np.zeros((len(self.graphs), len(self._edge_index)))
        for r, g in enumerate(self.graphs):
            for (a, b), j in g["edges"]:
                jv[r, self._edge_index[(min(a, b), max(a, b))]] = j
        return jv

    def _union_edges(self):
        """The union graph's edges ``(ea, eb)`` int64, in edge-id order."""
        pairs = sorted(self._edge_index.items(), key=lambda kv: kv[1])
        return np.array([a for (a, _), _ in pairs], np.int64), np.array([b for (_, b), _ in pairs], np.int64)

    def _ltau(self, ltau: Optional[int] = None) -> int:
        """``ltau``, or by default the largest ``choose_ltau`` of the rungs."""
        return int(ltau) if ltau else max(choose_ltau(g["beta"], g["transverse"], self.dtau) for g in self.graphs)

    def _on_kernel(self, ltau: Optional[int] = None) -> bool:
        """Whether the ladder's sweeps take the kernel (``ops/ladder``): no
        replica with RVB, and a union graph and L_tau that ``ladder.gate``
        takes, at any replica count. Shapes only: nothing is built."""
        ea, eb = self._union_edges()
        return (not any(g["rvb"] for g in self.graphs)
                and ladder.gate(detect_topology(self.nvars, ea, eb), self.nvars, self._ltau(ltau)) is None)

    def _materialize(self, ltau: Optional[int] = None) -> dict:
        """The ladder's tensors, built at first use; ``ltau`` sets the slice
        count there (default: the largest ``choose_ltau`` of the rungs)."""
        if self._mat is not None:
            return self._mat
        if not self.graphs:
            raise ValueError("No graphs added to tempering container")
        R, nvars, dev = len(self.graphs), self.nvars, self.device
        ea, eb = self._union_edges()
        jv = self._union_jvals()
        betas = np.array([g["beta"] for g in self.graphs])
        gammas = np.array([g["transverse"] for g in self.graphs])
        hs = np.array([g["longitudinal"] for g in self.graphs])
        L = self._ltau(ltau)
        rvb = np.array([g["rvb"] for g in self.graphs])
        topo = detect_topology(nvars, ea, eb)
        generic = not self._on_kernel(L)
        key_data = key_data_from_seeds(np.array([g["seed"] for g in self.graphs], np.uint64))
        if self._restored is not None:
            s = self._restored.to(dev)
            if s.shape[2] != L:  # regrid (nearest slice) if the ladder changed
                s = s[:, :, torch.from_numpy(np.arange(L) * s.shape[2] // L).to(dev)]
            self._restored = None
        else:
            s = torch.from_numpy(random_states(key_data, nvars)).to(dev)[:, :, None].expand(R, nvars, L)
        if self._swapkey is None:
            self._swapkey = key_data_from_seeds(self.rng.make_seeds(1))[0]
        p = make_params(betas, gammas, hs, L, dev)
        a = p.dtau * p.gamma
        self._mat = dict(
            L=L,
            ea=torch.from_numpy(ea.astype(np.int32)).to(dev),
            eb=torch.from_numpy(eb.astype(np.int32)).to(dev),
            jv=torch.from_numpy(jv.astype(np.float32)).to(dev),
            p=p,
            log_cosh=torch.log(torch.cosh(a)),
            log_sinh=torch.log(torch.sinh(a)),
            s=s.contiguous(),
            key_data=key_data,
            phase=0,
        )
        if generic:
            cg = compile_graph_arrays(nvars, ea, eb, np.ones(len(ea)))
            self._mat.update(ga=batched_graph_arrays(cg, jv, dev), rvb=torch.from_numpy(rvb).to(dev),
                             any_rvb=bool(rvb.any()))
        else:
            self._mat["planes"] = ladder.build_planes(topo[0], topo[1], nvars, ea, eb, jv, betas, gammas, hs, L, dev)
        return self._mat

    # ------------------------------------------------------------------- runs

    def _swap(self, m: dict, s, features, u, phase: int):
        """One even/odd swap step with uniforms ``u[R]``: returns the new
        state and the accepted count (a device scalar). Under a shard, ``s``
        and ``features`` are this rank's block; the decisions are taken on the
        gathered features, the same on every rank."""
        shard = m.get("shard")
        # the features as one [R, E + 2] tensor, so that a roll is one operation (torch's roll first copies a
        # strided tensor, such as the kernels' views of one [R, E + 2] tensor, to a contiguous one)
        f = torch.cat([features[0], features[1][:, None], features[2][:, None]], 1)
        if shard is not None:
            f = shard.gather(f.long())
        _, nvars, L = s.shape
        R = f.shape[0]
        ntot = nvars * L
        p, jv = m["p"], m["jv"]

        def log_weight(f):
            P, S, A = f[:, :-2], f[:, -2], f[:, -1].to(torch.float32)
            diag = -p.dtau * ((jv * P.to(torch.float32)).sum(-1) + p.h * S.to(torch.float32))
            return diag + A * m["log_cosh"] + (ntot - A) * m["log_sinh"]

        lw_self = log_weight(f)
        lw_up = log_weight(f.roll(-1, 0))  # log W_r(x_{r+1})
        lw_dn = log_weight(f.roll(1, 0))  # log W_r(x_{r-1})
        delta = lw_up + lw_dn.roll(-1, 0) - lw_self - lw_self.roll(-1, 0)
        idx = torch.arange(R, device=s.device)
        leader = ((idx % 2) == phase) & (idx + 1 < R)
        acc_leader = leader & (torch.log(u) < delta)
        acc_follower = acc_leader.roll(1, 0) & (idx > 0)
        perm = torch.where(acc_leader, idx + 1, torch.where(acc_follower, idx - 1, idx))
        return (s[perm] if shard is None else shard.take(s, perm)), acc_leader.sum()

    def _tables(self, m: dict, T: int, sf: int, seeds: bool = True):
        """A call's tables on the ladder's device, ``(seeds [T, R] int32 or
        None without ``seeds``, uniforms [T // sf, ngraphs] f32)``, with
        ``m["key_data"]`` and the swap key advanced past the call: made by
        ``key_tables_device`` (``swap_uniforms_device``), the keys copied there
        and back once; past ``rng._MAX_M`` rungs by the numpy ``key_tables``
        (``swap_uniforms``)."""
        n, dev = len(self.graphs), self.device
        if n > _MAX_M:
            if not seeds:
                uniforms, self._swapkey = swap_uniforms(self._swapkey, T // sf, n)
                return None, torch.from_numpy(uniforms).to(dev)
            seeds, uniforms, m["key_data"], self._swapkey = key_tables(m["key_data"], self._swapkey, T, sf, n)
            return torch.from_numpy(seeds).to(dev), torch.from_numpy(uniforms).to(dev)
        if not seeds:
            uniforms, sk = swap_uniforms_device(key_tensor(self._swapkey, dev), T // sf, n)
            self._swapkey = key_data_of(sk)[0]
            return None, uniforms
        kt = key_tensor(np.concatenate([m["key_data"], self._swapkey[None]]), dev)
        seeds, uniforms, keys, sk = key_tables_device(kt[:-1], kt[-1], T, sf, n)
        kd = key_data_of(torch.cat([keys, sk[None]]))
        m["key_data"], self._swapkey = kd[:-1], kd[-1]
        return seeds, uniforms

    @staticmethod
    def _gather(m: dict, x):
        """The global per-replica results from this rank's block (``x`` itself unsharded)."""
        shard = m.get("shard")
        return x if shard is None else shard.gather(x)

    def _run(self, timesteps: int, swap_freq: Optional[int], sampling_freq: int = 0, with_energy: bool = True):
        """``timesteps`` sweeps, a swap step after every ``swap_freq``-th
        (none when None), slice 0 recorded after every ``sampling_freq``-th
        sweep's swap. Returns ``(esum [R] f64 or None, samples [n, R, nvars]
        int8 on the device)``."""
        m = self._materialize()
        T, sf, freq = int(timesteps), int(swap_freq) if swap_freq else _NEVER, int(sampling_freq)
        if "ga" in m:
            return self._run_generic(m, T, sf, freq, with_energy)
        nsamples = T // freq if freq else 0
        s, planes, dev = m["s"], m["planes"], self.device
        R = s.shape[0]  # this rank's replicas under a shard
        with span("tempering.key_tables"):
            seeds, uniforms = self._tables(m, T, sf)
        sums = None
        if with_energy:
            sums = [torch.zeros((R, m["ea"].numel()), dtype=torch.int64, device=dev),
                    torch.zeros(R, dtype=torch.int64, device=dev), torch.zeros(R, dtype=torch.int64, device=dev)]
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        samples, nswaps, t = [], 0, 0
        while t < T:
            stop = T
            if with_energy:
                stop = t + 1
            else:
                stop = min(stop, (t // sf + 1) * sf)
                if t < nsamples * freq:
                    stop = min(stop, (t // freq + 1) * freq)
            # the call returns the features of its final state
            s, features = ladder.ladder_sweeps(s, seeds[t:stop], planes, stop - t, (m["ea"], m["eb"]))
            t = stop
            if with_energy:
                for acc, f in zip(sums, features):
                    acc += f
            if t % sf == 0:
                s, n = self._swap(m, s, features, uniforms[nswaps], m["phase"])
                accepted += n
                nswaps += 1
                m["phase"] = 1 - m["phase"]
            if freq and t % freq == 0 and t // freq <= nsamples:
                samples.append(s[:, :, 0])
        m["s"] = s
        self.total_swaps += int(accepted)  # waits for the sweeps, before the samples' span
        with span("tempering.samples"):
            out = self._gather(m, torch.stack(samples, 1) if samples else s.new_empty((R, 0, self.nvars)))
            out = out.transpose(0, 1)
        return (self._energy_sum(m, T, self._gather(m, sums)) if with_energy else None), out

    def _run_generic(self, m: dict, T: int, sf: int, freq: int, with_energy: bool):
        """``_run`` on the generic route: each sweep is ``worldline.sweep``
        from its row of the key chain, then (``with_energy``) the energy
        estimator's compensated sum, then the swap step where one is due, then
        the sample where one is due."""
        ga, dev = m["ga"], self.device
        p = m["p"] if "shard" not in m else type(m["p"])(*(m["shard"].block(x) for x in m["p"]))
        R = m["s"].shape[0]  # this rank's replicas under a shard
        nsamples = T // freq if freq else 0
        with span("tempering.key_tables"):
            _, uniforms = self._tables(m, T, sf, seeds=False)
        ea, eb = m["ea"].long(), m["eb"].long()
        esum = kzero(R, dev)
        accepted = torch.zeros((), dtype=torch.int64, device=dev)
        samples = []

        def step(t, s, seeds):
            nonlocal esum, accepted
            s = wl.sweep(ga, p, s, seeds, True, m["any_rvb"], rvb_replicas=m["rvb"])
            if with_energy:
                esum = kadd(esum, wl.total_energy(ga, p, s))
            if (t + 1) % sf == 0:
                s, n = self._swap(m, s, swap_features(s, ea, eb), uniforms[(t + 1) // sf - 1], m["phase"])
                accepted += n
                m["phase"] = 1 - m["phase"]
            if freq and (t + 1) % freq == 0 and (t + 1) // freq <= nsamples:
                samples.append(s[:, :, 0].clone())
            return s

        slots = wl.sweep_slots(ga, True, m["any_rvb"])
        m["s"], keys = wl.walk(m["s"], key_tensor(m["key_data"], dev), T, slots, step)
        m["key_data"] = key_data_of(keys)
        self.total_swaps += int(accepted)
        with span("tempering.samples"):
            out = self._gather(m, torch.stack(samples, 1) if samples else m["s"].new_empty((R, 0, self.nvars)))
            out = out.transpose(0, 1)
        return (kfinal(self._gather(m, esum)) if with_energy else None), out

    def _energy_sum(self, m: dict, T: int, sums) -> np.ndarray:
        """The energy estimator summed over ``T`` sweeps, per replica slot, from
        the feature sums (f64 on the host): the slice-averaged diagonal energy
        plus ``-Gamma * sum_i mean_tau w``, w = tanh(a) on aligned time bonds
        and coth(a) elsewhere, with the f32 parameters of ``make_params``."""
        P, S, A = (x.cpu().numpy().astype(np.float64) for x in sums)
        p = m["p"]
        jv, h, gamma = (x.cpu().numpy().astype(np.float64) for x in (m["jv"], p.h, p.gamma))
        tanh_a = np.tanh((p.dtau * p.gamma).cpu().numpy().astype(np.float64))
        L = m["L"]
        ediag = ((jv * P).sum(1) + h * S) / L
        eoff = -gamma * (tanh_a * A + (T * self.nvars * L - A) / tanh_a) / L
        return ediag + eoff

    def qmc_timesteps(self, t: int) -> None:
        """Sweeps, no swaps, no estimators."""
        self._run(int(t), None, with_energy=False)

    def qmc_timesteps_sample(self, timesteps: int, replica_swap_freq: Optional[int] = None,
                             sampling_freq: Optional[int] = None):
        """-> (states [ngraphs, t/sfreq, nvars] bool, avg_energies [ngraphs]
        f64): sweeps, neighbour swaps every ``replica_swap_freq`` (default 1),
        slice-0 samples every ``sampling_freq`` (default 1)."""
        with span("tempering.qmc_timesteps_sample"):
            swap_freq = int(replica_swap_freq) if replica_swap_freq else 1
            sfreq = int(sampling_freq) if sampling_freq else 1
            esum, states = self._run(int(timesteps), swap_freq, sfreq)
            with span("tempering.samples"):
                states = np.swapaxes((states == 1).cpu().numpy(), 0, 1)  # [R, t/sfreq, nvars]
            return states, esum / max(int(timesteps), 1)

    def get_graph_itime(self, g: int) -> np.ndarray:
        """-> bool [L, nvars], the worldline of replica g."""
        g = int(g)
        if g < 0 or g >= len(self.graphs):
            raise ValueError(f"Graph index {g} out of bounds")
        m = self._materialize()
        return (self._gather(m, m["s"])[g].T == 1).cpu().numpy()

    # ---------------------------------------------------------- correlations

    def _autocorr(self, timesteps, sampling_wait_buffer, replica_swap_freq, sampling_freq, series_fn):
        """Autocorrelation of the ``sampling_freq``-sampled series after a wait
        buffer (which swaps too), zero-padded into ``[ngraphs, timesteps]``."""
        wait = int(sampling_wait_buffer or 0)
        swap_freq = int(replica_swap_freq) if replica_swap_freq else 1
        freq = int(sampling_freq) if sampling_freq else 1
        if wait:
            self._run(wait, swap_freq, with_energy=False)
        _, states = self._run(int(timesteps), swap_freq, freq, with_energy=False)
        x = states.to(torch.float32).transpose(0, 1)  # [R, t/freq, nvars]
        return pad_autocorr(autocorrelation_device(series_fn(x)), int(timesteps))

    def run_quantum_monte_carlo_and_measure_variable_autocorrelation(
            self, timesteps: int, sampling_wait_buffer: Optional[int] = None,
            replica_swap_freq: Optional[int] = None, sampling_freq: Optional[int] = None):
        """-> corrs [ngraphs, timesteps] f64, with swaps interleaved."""
        return self._autocorr(timesteps, sampling_wait_buffer, replica_swap_freq, sampling_freq, lambda x: x)

    def run_quantum_monte_carlo_and_measure_bond_autocorrelation(
            self, timesteps: int, sampling_wait_buffer: Optional[int] = None,
            replica_swap_freq: Optional[int] = None, sampling_freq: Optional[int] = None):
        """-> corrs [ngraphs, timesteps] f64 of the union graph's bond products."""
        m = self._materialize()
        ea, eb = m["ea"], m["eb"]
        return self._autocorr(timesteps, sampling_wait_buffer, replica_swap_freq, sampling_freq,
                              lambda x: x[:, :, ea] * x[:, :, eb])

    # ----------------------------------------------------------- persistence

    def clone(self) -> "LatticeTempering":
        """An independent copy (runs never modify a materialized tensor in place)."""
        other = LatticeTempering.__new__(LatticeTempering)
        other.__dict__.update(self.__dict__)
        other.rng = self.rng.clone()
        other.graphs = [dict(g) for g in self.graphs]
        other._edge_index = dict(self._edge_index)
        if self._mat is not None:
            other._mat = dict(self._mat)
        return other

    def save_to_file(self, path: str) -> None:
        """CBOR (nvars, edges, cutoff, seed, use_allocator, container), the JAX
        package's file; the random state is not saved."""
        states = None if self._mat is None else self._gather(self._mat, self._mat["s"]).cpu().numpy()
        container = [
            {
                "transverse": g["transverse"],
                "longitudinal": g["longitudinal"],
                "beta": g["beta"],
                "edges": [[list(ab), j] for ab, j in g["edges"]],
                "rvb": g["rvb"],
                "heatbath": g["heatbath"],
                "worldline": None if states is None else (states[r] == 1),
            }
            for r, g in enumerate(self.graphs)
        ]
        cbor.dump([self.nvars, [[list(ab), j] for ab, j in self.edges], self.cutoff,
                   None if self.seed is None else int(self.seed), self.use_allocator,
                   {"graphs": container, "total_swaps": int(self.total_swaps)}], path)

    @staticmethod
    def read_from_file(path: str, reseed: Optional[int] = None, *, device="cuda") -> "LatticeTempering":
        """Reload a checkpoint; the per-replica seeds are drawn anew from
        ``reseed`` (or entropy), and saved worldlines are regridded if the
        ladder's L_tau changed."""
        nvars, edges, cutoff, seed, use_alloc, container = cbor.load(path)
        out = LatticeTempering([((int(a), int(b)), float(j)) for (a, b), j in edges], seed=reseed,
                               use_allocator=use_alloc, device=device)
        states = []
        for g in container["graphs"]:
            out.add_graph(g["transverse"], g["longitudinal"], g["beta"],
                          edges=[((int(a), int(b)), float(j)) for (a, b), j in g["edges"]],
                          enable_rvb_update=g["rvb"], enable_heatbath_update=g["heatbath"])
            states.append(None if g["worldline"] is None else np.where(g["worldline"], 1, -1).astype(np.int8))
        out.total_swaps = int(container["total_swaps"])
        if states and all(x is not None for x in states):
            out._restored = torch.from_numpy(np.stack(states))
        return out
