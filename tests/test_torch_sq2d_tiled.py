"""The tiled square-torus kernel of the port (``ops/sq2d.sq2d_plan``,
``sq2d_tiled`` in ``csrc/sq2d.cu``): its plan and its schedule.

The plan decides (tile side B, sweeps a launch K) by shape alone, from the
opt-in shared memory per block and the SM count that the caller passes in
(232,448 bytes and 132 SMs on an H100). The schedule is emulated here in
plain torch from the constants that ``ops/sq2d.py`` exports
(``HALO_PER_SWEEP``, ``phase_margin``): each launch cuts each tile's box (the
tile and a halo of 2K sites, at global coordinates mod L) from the state the
launch starts from, each phase updates its color only at the box sites at
least ``phase_margin(j)`` from the box's edge with every draw at the site's
global key, samples are taken from the interiors, and the interiors make the
next state. That emulation must equal ``sweeps_2d_reference`` bit for bit
(states and samples; tolerance: none), and the same schedule with a halo one
site short must not. The CUDA kernel itself runs only on the card, where
``chip_smoke.py`` holds it to the plain version bit for bit."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyisingmontecarlo_tpu_torch.ops import sq2d
from pyisingmontecarlo_tpu_torch.ops.lanerng import lane_draw31, make_pos_mix
from pyisingmontecarlo_tpu_torch.ops.lattice2d import random_states_2d
from pyisingmontecarlo_tpu_torch.rng import replica_seeds_i32

torch.set_num_threads(1)

H100_OPTIN, H100_SMS = 232448, 132


# --- the plan ----------------------------------------------------------------


def test_main_shape_plan():
    """1024^2 x 8 (bench.py's shape): tiles of 256, 8 sweeps a launch, a 288^2
    box of 2 x 288 x 144 bytes of spins (rows padded to 16), 128 blocks (one
    an SM), so 128 launches for 1024 sweeps."""
    B, K, w, nbytes = sq2d.sq2d_plan(1024, 8, H100_OPTIN, H100_SMS)
    assert (B, K, w) == (256, 8, 288)
    assert nbytes == sq2d.tiled_bytes(256, 8) == 2 * 288 * 144 + 4 * 80 + 4 * 144 + 4 * 288
    assert 8 * (1024 // B) ** 2 == 128 <= H100_SMS and -(-1024 // K) == 128


def test_explicit_randoms_plan_keeps_several_blocks_an_sm():
    """Draws read from random planes in HBM need several blocks an SM to hide
    their latency: at the main shape, tiles of 128 and 8 sweeps a launch (512
    blocks, 4 an SM) in place of one block an SM."""
    B, K, w, nbytes = sq2d.sq2d_plan(1024, 8, H100_OPTIN, H100_SMS, rb=True)
    assert (B, K, w, nbytes) == (128, 8, 160, sq2d.tiled_bytes(128, 8))
    assert 8 * (1024 // B) ** 2 / H100_SMS > sq2d.PLAN_RB_BLOCKS_PER_SM - 1


@pytest.mark.parametrize("L", [4, 6, 16])
def test_lattices_smaller_than_the_box(L):
    """The smallest tile, one a side, in a box larger than the lattice."""
    B, K, w, nbytes = sq2d.sq2d_plan(L, 1, H100_OPTIN, H100_SMS)
    assert B == sq2d.TILE_STEP and w == B + 4 * K > L and nbytes <= H100_OPTIN


@pytest.mark.parametrize("L,R", [(1000, 8), (2048, 8), (1024, 1), (1024, 1024), (64, 4), (200, 2), (4096, 2)])
def test_plan_invariants(L, R):
    B, K, w, nbytes = sq2d.sq2d_plan(L, R, H100_OPTIN, H100_SMS)
    assert B % sq2d.TILE_STEP == 0 and sq2d.TILE_STEP <= B <= min(sq2d.TILE_MAX, -(-L // 8) * 8)
    assert K in sq2d.SWEEPS_PER_LAUNCH and w == B + 2 * sq2d.HALO_PER_SWEEP * K
    assert nbytes == sq2d.tiled_bytes(B, K) <= H100_OPTIN and w // 8 + 1 <= sq2d.TILED_THREADS
    # the least tile of its count a side: one step less would take more tiles
    assert B == sq2d.TILE_STEP or -(-L // (B - sq2d.TILE_STEP)) > -(-L // B)


@pytest.mark.parametrize("L,R,rb,want", [(1024, 1, False, (96, 4)), (1000, 8, False, (256, 8)),
                                         (2048, 8, False, (256, 8)), (256, 64, False, (128, 4))])
def test_plan_at_the_timed_shapes(L, R, rb, want):
    """The shapes where chip_smoke.py times the plan's pick against a (B, K)
    grid: one replica (11 tiles a side, 121 blocks), a side no tile divides,
    a larger lattice (512 blocks), many small lattices (B = 256 would make
    64 blocks, half the card); 8 sweeps a launch only on tiles of 256."""
    assert sq2d.sq2d_plan(L, R, H100_OPTIN, H100_SMS, rb)[:2] == want


def test_plan_at_a_side_no_tile_divides():
    """L = 1000 takes a partial last tile a side; the plan still keeps most
    of the card busy."""
    B, K, _, _ = sq2d.sq2d_plan(1000, 8, H100_OPTIN, H100_SMS)
    assert 1000 % B and 8 * (-(-1000 // B)) ** 2 >= 0.9 * H100_SMS


def test_plan_fills_the_card_by_replicas():
    """Few replicas take smaller tiles than many, so that the blocks still
    cover most of the 132 SMs (one block an SM keeps it busy)."""
    few = sq2d.sq2d_plan(1024, 1, H100_OPTIN, H100_SMS)[0]
    many = sq2d.sq2d_plan(1024, 1024, H100_OPTIN, H100_SMS)[0]
    assert few < many
    assert 0.9 * H100_SMS <= (-(-1024 // few)) ** 2 <= H100_SMS


def test_plan_reads_the_limit_it_is_given():
    B, K, _, nbytes = sq2d.sq2d_plan(1024, 8, H100_OPTIN, H100_SMS)
    assert sq2d.sq2d_plan(1024, 8, nbytes, H100_SMS)[:2] == (B, K)
    assert sq2d.sq2d_plan(1024, 8, nbytes - 1, H100_SMS)[:2] != (B, K)
    least = sq2d.tiled_bytes(8, 2)
    assert sq2d.sq2d_plan(1024, 8, least, H100_SMS)[:2] == (8, 2)
    assert sq2d.sq2d_plan(1024, 8, least - 1, H100_SMS) is None


def test_tiled_bytes_grow_with_the_box():
    for B, K in ((8, 2), (128, 4), (256, 16)):
        w = B + 4 * K
        assert sq2d.tiled_bytes(B, K) >= 2 * w * (w // 2)
        assert sq2d.tiled_bytes(B + 8, K) > sq2d.tiled_bytes(B, K) < sq2d.tiled_bytes(B, 2 * K)


def test_phase_margin_leaves_the_tile_exact():
    """After the 2K phases of a launch the exact region has shrunk by
    phase_margin(2K - 1) sites, exactly the halo."""
    for K in sq2d.SWEEPS_PER_LAUNCH:
        assert sq2d.phase_margin(2 * K - 1) == sq2d.HALO_PER_SWEEP * K
        assert [sq2d.phase_margin(j) for j in range(2 * K)] == list(range(1, 2 * K + 1))


# --- a plain-torch emulation of the schedule ---------------------------------


def tiled_emulation(s, seeds, thr, ctr0, rb=None, samples=None, B=8, K=2, halo=None):
    """``sweeps_2d``' result by the tile schedule, in plain torch."""
    R, L, _ = s.shape
    T, W = thr.shape[0], L // 2
    halo = sq2d.HALO_PER_SWEEP * K if halo is None else halo
    w = B + 2 * halo
    u = torch.arange(w)
    edge = torch.minimum(torch.minimum(u[:, None], w - 1 - u[:, None]), torch.minimum(u[None, :], w - 1 - u[None, :]))
    stack = torch.empty((R, T // samples, L, L), dtype=torch.int8) if samples else None
    cur = s.clone()
    for t0 in range(0, T, K):
        nxt = torch.empty_like(cur)
        for X0 in range(0, L, B):
            for Y0 in range(0, L, B):
                xs, ys = (X0 - halo + u) % L, (Y0 - halo + u) % L
                box = cur[:, xs][:, :, ys].to(torch.int32)
                color = (xs[:, None] + ys[None, :]) % 2
                pos1, pos2 = make_pos_mix(torch.zeros(1, dtype=torch.int64),
                                          (xs[:, None] * W + ys[None, :] // 2).reshape(-1), 0)
                bx, by = min(B, L - X0), min(B, L - Y0)

                def interior():
                    return box[:, halo:halo + bx, halo:halo + by].to(torch.int8)

                for j in range(2 * min(K, T - t0)):
                    t, p = t0 + j // 2, j % 2
                    nsum = box.roll(1, 1) + box.roll(-1, 1) + box.roll(1, 2) + box.roll(-1, 2)
                    tv = thr[t][5 * (box > 0) + (nsum + 4) // 2]
                    if rb is not None:
                        draw = rb[2 * t + p][xs][:, ys // 2][None]
                    else:
                        draw = lane_draw31(seeds[:, None], pos1, pos2, 2 * (ctr0 + t) + p).reshape(R, w, w)
                    hit = (color == p) & (edge >= sq2d.phase_margin(j)) & (draw <= tv)
                    box = torch.where(hit, -box, box)
                    if p == 1 and samples and (t + 1) % samples == 0:
                        stack[:, (t + 1) // samples - 1, X0:X0 + bx, Y0:Y0 + by] = interior()
                nxt[:, X0:X0 + bx, Y0:Y0 + by] = interior()
        cur = nxt
    return (cur, stack) if samples else cur


def _inputs(L, R, seed):
    u64 = np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64)
    seeds = torch.from_numpy(replica_seeds_i32(u64))
    return random_states_2d(seeds, L), seeds


def _rb(L, T, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 2**31, (2 * T, L, L // 2), dtype=np.int64).astype(np.int32))


# name, L, R, T, B, K, ctr0, beta schedule (None: constant 0.44), sampling period, explicit randoms
CASES = [
    ("hash, T not a multiple of K, ctr0 > 0", 16, 2, 7, 8, 2, 3, None, None, False),
    ("annealing rows changing inside a launch", 24, 2, 10, 8, 4, 0, (0.1, 1.2), None, False),
    ("explicit randoms over three launches", 16, 2, 5, 8, 2, 0, None, None, True),
    ("explicit randoms, annealing, K=4", 16, 1, 9, 8, 4, 2, (0.2, 0.9), None, True),
    ("sampling every 3 sweeps, K=4", 16, 2, 13, 8, 4, 5, None, 3, False),
    ("sampling every sweep (collect_energies), K=4", 16, 1, 6, 8, 4, 0, None, 1, False),
    ("L=6 smaller than the box", 6, 3, 7, 8, 2, 1, (0.3, 0.6), None, False),
    ("L=4 smaller than the box, K=4", 4, 2, 9, 8, 4, 0, None, 2, False),
    ("partial last tile (L=20, B=8)", 20, 1, 5, 8, 2, 0, None, None, False),
    ("tile of 16, K=8, across two launches", 32, 1, 11, 16, 8, 4, (0.3, 0.7), None, False),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_schedule_equals_plain_version(case):
    """Tolerance: none."""
    _, L, R, T, B, K, ctr0, sched, freq, use_rb = case
    s, seeds = _inputs(L, R, L * 31 + T)
    betas = np.full(T, 0.44, np.float32) if sched is None else np.linspace(*sched, T).astype(np.float32)
    thr = sq2d.thresholds(betas, -1.0, 0.1)
    rb = _rb(L, T, T) if use_rb else None
    want = sq2d.sweeps_2d_reference(s, seeds, thr, ctr0, rb, freq)
    got = tiled_emulation(s, seeds, thr, ctr0, rb, freq, B, K)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert not torch.equal(want[0], s)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_schedule_with_the_plans_tile():
    """The (B, K) that the plan picks for a small lattice, over two launches."""
    B, K, _, _ = sq2d.sq2d_plan(16, 2, H100_OPTIN, H100_SMS)
    s, seeds = _inputs(16, 2, 5)
    thr = sq2d.thresholds(np.linspace(0.2, 0.8, K + 3).astype(np.float32), -1.0, 0.0)
    assert torch.equal(tiled_emulation(s, seeds, thr, 1, B=B, K=K), sq2d.sweeps_2d_reference(s, seeds, thr, 1))


def test_a_halo_one_site_short_differs():
    """Negative control: the same schedule with a halo of 2K - 1 sites
    updates the tile's edge from neighbours that are already stale."""
    s, seeds = _inputs(16, 2, 9)
    thr = sq2d.thresholds(np.full(4, 0.3, np.float32), -1.0, 0.0)
    want = sq2d.sweeps_2d_reference(s, seeds, thr, 0)
    assert torch.equal(tiled_emulation(s, seeds, thr, 0, B=8, K=2), want)
    assert not torch.equal(tiled_emulation(s, seeds, thr, 0, B=8, K=2, halo=3), want)


# --- the kernel's flip test -----------------------------------------------------

I32_ENDS = np.array([-2**31, -2**31 + 1, -2**30, -2, -1, 0, 1, 2**30, 2**31 - 2, 2**31 - 1], np.int64)


def kernel_flips(u, t, rb, clamp=True, correct=True):
    """``csrc/sq2d.cu``'s flip test on int64 arrays of int32 values, in
    uint32 arithmetic as the kernel does it: the table stores ``~t`` (with
    hashed draws ``~max(t, -1)``), ``d = u + ~t`` wraps mod 2^32 and, with
    draws from random planes, bit 31 of ``d ^ ((d ^ u) & (d ^ ~t))`` is the
    exact sum's sign (``flip_sign``); the site flips where bit 31 is set.
    ``clamp`` and ``correct`` off are the versions without those steps."""
    m = 0xFFFFFFFF
    nt = ~(t if rb or not clamp else np.maximum(t, -1)) & m
    uu = u & m
    d = (uu + nt) & m
    if rb and correct:
        d = d ^ ((d ^ uu) & (d ^ nt))
    return (d >> 31) == 1


@pytest.mark.parametrize("mode", ["hashed draws", "random planes"])
def test_flip_test_is_exact_over_int32(mode):
    """The kernel flips where ``u <= t``, as the plain version does, for every
    threshold and every draw its mode gives: hashed draws lie in [0, 2^31),
    draws from random planes are any int32. Without the clamp (hashed) or the
    sign correction (random planes), ``u + ~t`` overflows and some differ."""
    rng = np.random.default_rng(3)
    lo = 0 if mode == "hashed draws" else -2**31
    u = np.concatenate([I32_ENDS[I32_ENDS >= lo], rng.integers(lo, 2**31, 2000)])
    t = np.concatenate([I32_ENDS, rng.integers(-2**31, 2**31, 2000)])
    u, t = np.meshgrid(u, t)
    rb = mode == "random planes"
    assert np.array_equal(kernel_flips(u, t, rb), u <= t)
    broken = kernel_flips(u, t, rb, clamp=False) if not rb else kernel_flips(u, t, rb, correct=False)
    assert not np.array_equal(broken, u <= t)


# --- the wrapper -------------------------------------------------------------


@pytest.mark.parametrize("mode", ["plain", "sampling", "explicit randoms"])
def test_cpu_tensor_launches_nothing(mode):
    s, seeds = _inputs(8, 2, 1)
    thr = sq2d.thresholds(np.full(4, 0.5, np.float32), -1.0, 0.0)
    kw = {"plain": {}, "sampling": dict(samples=2), "explicit randoms": dict(rb=_rb(8, 4, 1))}[mode]
    before = sq2d.sweeps_2d.launches
    got = sq2d.sweeps_2d(s, seeds, thr, 0, **kw)
    want = sq2d.sweeps_2d_reference(s, seeds, thr, 0, **kw)
    assert sq2d.sweeps_2d.launches == before
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
