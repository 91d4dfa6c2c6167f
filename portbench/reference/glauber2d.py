"""Checkerboard Glauber sweeps of a uniform periodic square Ising lattice,
in plain torch: what ``Lattice.run_monte_carlo`` computes on such a lattice,
worked out again from the rule.

Spins are +-1 on an L x L torus (site ``x * L + y``). Experiment r of a call
gets the u64 seed ``s_r`` of the master stream and the int32 kernel seed
``k_r`` of the key ``[s_r >> 32, s_r & 0xFFFFFFFF]`` (``threefry.kernel_seeds``).
Its initial spin at (x, y) is +1 where ``draw31(k_r, x L + y, 2^31 - 1) <
2^30``. Sweep t is two phases: p = 0 updates the sites with x + y even,
p = 1 the others. A site of the phase, at packed column ``c = y // 2``, with
spin s and neighbour sum B flips when ``draw31(k_r, x (L/2) + c, 2t + p) <=
thr[5 (s > 0) + (B + 4) / 2]``, where ``thr`` holds ``sigmoid(-beta dE) *
(2^31 - 1)`` for ``dE = -2 s (J B + h)``, computed in f32 on the CPU and
clamped to [0, 2^31 - 1]. The energy is ``J * sum_bonds s_a s_b + h * sum_i
s_i`` in f32 from the exact integer sums.

The lattice is held as two packed planes ``[n, L, L/2]``: E the sites with
x + y even (column c at y = 2c + x % 2), O the others (y = 2c + 1 - x % 2).
"""

from __future__ import annotations

import numpy as np
import torch

from .lanehash import draw31, pos_words, wrap32

__all__ = ["INIT_CTR", "thresholds", "initial_states", "sweeps", "energies", "unpack"]

INIT_CTR = 0x7FFFFFFF
_I31 = 2**31 - 1


def _dE(j: float, h: float) -> np.ndarray:
    out = np.empty(10, np.float32)
    for si, s in enumerate((-1.0, 1.0)):
        for bi, B in enumerate((-4.0, -2.0, 0.0, 2.0, 4.0)):
            out[si * 5 + bi] = -2.0 * s * (j * B + h)
    return out


def thresholds(betas, j: float, h: float, dtype=torch.float32) -> torch.Tensor:
    """``[n, 10]`` int32 Glauber thresholds for each beta, on the CPU, with
    the product and the sigmoid in ``dtype`` (float32 as the rule states)."""
    b = torch.from_numpy(np.asarray(betas, np.float32).reshape(-1)).to(dtype)
    x = (-b)[:, None] * torch.from_numpy(_dE(j, h)).to(dtype)[None, :]
    p = torch.sigmoid(x) * 2147483647.0
    return p.to(torch.float64).clamp_(0, _I31).to(torch.int32)


def initial_states(seeds_i32: torch.Tensor, L: int):
    """Packed planes ``(E, O)`` of each seed's initial state."""
    dev = seeds_i32.device
    x = torch.arange(L, device=dev)[:, None]
    c = torch.arange(L // 2, device=dev)[None, :]
    planes = []
    for off in (x % 2, 1 - x % 2):
        pw1, pw2 = pos_words(x * L + 2 * c + off)
        u = draw31(seeds_i32[:, None, None], pw1, pw2, INIT_CTR)
        planes.append(torch.where(u < 2**30, 1, -1).to(torch.int8))
    return planes[0], planes[1]


def _shift_cols(P: torch.Tensor, row_even: torch.Tensor, even_shift: int) -> torch.Tensor:
    """The horizontal neighbour in the other plane that is not at the same
    column: column c - 1 (``roll`` +1) on rows of one parity, c + 1 on the
    others."""
    return torch.where(row_even, P.roll(even_shift, 2), P.roll(-even_shift, 2))


def sweeps(E: torch.Tensor, O: torch.Tensor, seeds_i32: torch.Tensor, thr: torch.Tensor, T: int):
    """``T`` sweeps from counter 0 on ``n`` replicas, replica r with its
    threshold row ``thr[r]``; returns the new ``(E, O)``. On the card one
    sweep's operations are captured in a CUDA graph and replayed ``T`` times
    (the same operations, without the host's launch cost)."""
    n, L, W = E.shape
    dev = E.device
    x = torch.arange(L, device=dev)[:, None]
    pw1, pw2 = pos_words(x * W + torch.arange(W, device=dev)[None, :])
    row_even = (x % 2 == 0)[None]
    seed = seeds_i32[:, None, None]
    thr = thr.to(dev)
    planes = [E.clone(), O.clone()]
    ctr = torch.zeros((), dtype=torch.int32, device=dev)

    def sweep():
        for p in (0, 1):
            S, N = planes[p], planes[1 - p]
            # E's sites (y = 2c + x % 2) have their other horizontal neighbour at c - 1 on even rows and c + 1
            # on odd rows; O's (y = 2c + 1 - x % 2) at c + 1 on even rows and c - 1 on odd rows
            B = N.roll(1, 1) + N.roll(-1, 1) + N + _shift_cols(N, row_even, 1 if p == 0 else -1)
            idx = (5 * (S > 0) + torch.div(B + 4, 2, rounding_mode="floor")).to(torch.int64)
            tv = thr.gather(1, idx.view(n, -1)).view(n, L, W)
            u = draw31(seed, pw1, pw2, ctr + p)
            S.copy_(torch.where(u <= tv, -S, S))
        ctr.add_(2)

    if dev.type != "cuda":
        for _ in range(T):
            sweep()
        return planes[0], planes[1]
    start = [p.clone() for p in planes]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sweep()  # the capture's warm-up, undone below
    torch.cuda.current_stream().wait_stream(side)
    for p, p0 in zip(planes, start):
        p.copy_(p0)
    ctr.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        sweep()
    for _ in range(T):
        graph.replay()
    return planes[0], planes[1]


def unpack(E: torch.Tensor, O: torch.Tensor) -> torch.Tensor:
    """``[n, L, L]`` int8 states of the packed planes."""
    n, L, W = E.shape
    odd_row = (torch.arange(L, device=E.device) % 2 == 1)[None, :, None]
    first = torch.where(odd_row, O, E)  # y = 2c
    second = torch.where(odd_row, E, O)  # y = 2c + 1
    return torch.stack([first, second], -1).reshape(n, L, L)


def energies(s: torch.Tensor, j: float, h: float) -> np.ndarray:
    """f64 energies (from f32 products) of ``[n, L, L]`` states."""
    s32 = s.to(torch.int32)
    bonds = (s32 * s32.roll(-1, 1)).sum((1, 2)) + (s32 * s32.roll(-1, 2)).sum((1, 2))
    spins = s32.sum((1, 2))
    b = bonds.cpu().numpy().astype(np.float32)
    m = spins.cpu().numpy().astype(np.float32)
    return (np.float32(j) * b + np.float32(h) * m).astype(np.float64)
