"""The uniform square torus (the benchmark workload): plain torch around the
sweep kernel of ``ops/sq2d.py``.

Counterpart of ``pyisingmontecarlo_tpu/ops/lattice2d.py``. Spins are
``[R, L, L]`` int8 in {-1, +1}; replica r is keyed by ``seeds_i32[r]`` and the
sweep counter ``ctr0`` of the randomness contract in ``ops/sq2d.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from .lanerng import lane_draw31, make_pos_mix
from .sq2d import sweeps_2d, thresholds

__all__ = ["run_steps_2d", "run_sampling_2d", "energy_2d", "random_states_2d"]

# draw counter of the initial states; sweep counters stay below 2^31 - 2
INIT_CTR = 0x7FFFFFFF
# bound on the per-chunk sample stack when energies are collected every sweep
_STACK_BYTES = 1 << 28
# bound on the sites whose initial draws are made at once (their int64 words: 1 GiB each)
_DRAW_SITES = 1 << 27


def random_states_2d(seeds_i32: torch.Tensor, L: int) -> torch.Tensor:
    """Uniformly random ``[R, L, L]`` int8 states: site (x, y) of replica r is
    +1 where ``lane_draw31(seed_r, pos = x*L + y, INIT_CTR) < 2^30``.

    The JAX package draws these with threefry Bernoulli; the port uses the lane
    hash at a counter no sweep uses, so the states (like the sweeps) depend only
    on each replica's own seed, but differ from the JAX package's. Drawn a
    block of replicas at a time (``_DRAW_SITES``), which bounds the draws'
    temporaries at any R."""
    dev = seeds_i32.device
    pos1, pos2 = make_pos_mix(torch.zeros(1, dtype=torch.int64, device=dev),
                              torch.arange(L * L, device=dev), 0)
    R = seeds_i32.shape[0]
    out = torch.empty((R, L, L), dtype=torch.int8, device=dev)
    step = max(1, _DRAW_SITES // (L * L))  # replicas at a time
    for a in range(0, R, step):
        u = lane_draw31(seeds_i32[a:a + step, None], pos1, pos2, INIT_CTR)
        out[a:a + step] = torch.where(u < 2**30, 1, -1).to(torch.int8).reshape(-1, L, L)
    return out


def energy_2d(s: torch.Tensor, j: float, h: float) -> torch.Tensor:
    """E[r] = J * sum_<ab> s_a s_b + h * sum_i s_i (each bond once), f32.

    Bond and spin sums are exact int32; only the two f32 multiplies and the add
    round, which matches the JAX package's f32 sums bit for bit for L^2 < 2^24."""
    bonds = (s * s.roll(-1, 1)).sum((1, 2), dtype=torch.int32) + (s * s.roll(-1, 2)).sum(
        (1, 2), dtype=torch.int32
    )
    spins = s.sum((1, 2), dtype=torch.int32)
    jf = torch.tensor(j, dtype=torch.float32, device=s.device)
    hf = torch.tensor(h, dtype=torch.float32, device=s.device)
    return jf * bonds.to(torch.float32) + hf * spins.to(torch.float32)


def _energies_from_samples(ss: torch.Tensor, j: float, h: float) -> torch.Tensor:
    """``energy_2d`` over a ``[R, T, L, L]`` sample stack -> ``[R, T]`` f32."""
    R, T, L, _ = ss.shape
    return energy_2d(ss.reshape(R * T, L, L), j, h).reshape(R, T)


def run_steps_2d(s, seeds_i32, beta_arr, j: float, h: float, collect_energies=False, ctr0: int = 0):
    """``len(beta_arr)`` sweeps, sweep t at ``beta_arr[t]``. Returns the final
    state, or ``(state, energies [R, T] f32)`` with the energy after every sweep
    when ``collect_energies``."""
    thr = thresholds(beta_arr, j, h).to(s.device)
    if not collect_energies:
        return sweeps_2d(s, seeds_i32, thr, ctr0)
    # stage every sweep's state through the kernel's sampling mode, in chunks
    # that bound the stack's memory
    R, L, _ = s.shape
    chunk = max(1, _STACK_BYTES // max(1, R * L * L))
    es = [torch.zeros((R, 0), dtype=torch.float32, device=s.device)]
    for c0 in range(0, thr.shape[0], chunk):
        s, ss = sweeps_2d(s, seeds_i32, thr[c0 : c0 + chunk], ctr0 + c0, samples=1)
        es.append(_energies_from_samples(ss, j, h))
    return s, torch.cat(es, dim=1)


def run_sampling_2d(s, seeds_i32, beta: float, j: float, h: float, timesteps: int,
                    sampling_freq: int, ctr0: int = 0):
    """``timesteps`` sweeps at constant ``beta``, the state recorded after every
    ``sampling_freq`` of them. Returns ``(final state, energies [R, n] f32,
    samples [R, n, L, L] int8)`` with ``n = timesteps // sampling_freq``."""
    thr = thresholds(np.full(int(timesteps), beta, np.float32), j, h).to(s.device)
    s, ss = sweeps_2d(s, seeds_i32, thr, ctr0, samples=int(sampling_freq))
    return s, _energies_from_samples(ss, j, h), ss
