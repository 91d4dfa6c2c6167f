"""The multi-launch route's accumulation, as ``wl_accumulate`` in
``csrc/wl.cu`` computes it, modelled in numpy, and the launches a sweep.

- A model of the kernel's word arithmetic: a warp a line, words of V bytes
  (2, 4, 8 or 16), four signed bytes a dp4a, the line's bond products with
  its outgoing partners (ring i + 1; torus y + 1, x + 1), its spin sum, and
  its aligned bonds from the line's bytes against the same bytes shifted down
  one (the next lane's first byte on top, slice 0 after the last); against
  the statistics that ``wl_sweeps_reference`` returns, on rings and tori, at
  L_tau = 2 mod 4 and at each word width.
- On the card, the launches a sweep: the wrappers' counters advance by
  ``LAUNCHES_PER_SWEEP`` a sweep on a real multi-launch call (skipped without
  CUDA; ``tests/test_torch_wl.py`` holds that the plain version adds none).

The model is a second copy of the kernel's rules and can drift from the CUDA
source: the kernels run only on the card, where ``chip_smoke.py`` compare-wl
and compare-ladder hold them to the plain versions bit for bit.
Tolerance: none; every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyisingmontecarlo_tpu_torch.ops import ladder, wl

torch.set_num_threads(1)


def _dp4a(a, b, c):
    """__dp4a on int32 arrays: the four signed byte products of a and b, summed, plus c."""
    out = c.astype(np.int64)
    for sh in (0, 8, 16, 24):
        out += ((a >> sh) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64) * \
            ((b >> sh) & 0xFF).astype(np.uint8).view(np.int8).astype(np.int64)
    return out


def _accumulate(x, kind, size, V):
    """[R, 3] int64 statistics of x [R, nvars, L] int8 as wl_accumulate<V>
    sums them: per line, 32-bit chunks of the words of V bytes (V = 2: the
    upper half zero), dp4a with the outgoing partners' chunks, with 0x01010101
    and with the chunk shifted down a byte, the next byte on top."""
    R, n, L = x.shape
    u = x.view(np.uint8).astype(np.uint32)
    if kind == "ring":
        partners = [np.roll(u, -1, 1)]
    else:
        q = u.reshape(R, size, size, L)
        partners = [np.roll(q, -1, 2).reshape(R, n, L), np.roll(q, -1, 1).reshape(R, n, L)]
    nxt = np.roll(u, -1, 2)  # the byte after each slice, slice 0 after the last
    B = min(V, 4)  # bytes a chunk holds
    sb = sh = pr = np.zeros((R, n), np.int64)
    for c0 in range(0, L, B):
        def chunk(a, first=c0):
            return sum(a[:, :, first + j] << (8 * j) for j in range(B))

        a = chunk(u)
        up = (a >> 8) | (nxt[:, :, c0 + B - 1] << (8 * (B - 1)))
        sh = _dp4a(a, np.uint32(0x01010101), sh)
        for p in partners:
            sb = _dp4a(a, chunk(p), sb)
        pr = _dp4a(a, up, pr)
    return np.stack([sb.sum(1), sh.sum(1), ((L + pr) // 2).sum(1)], 1)


@pytest.mark.parametrize("kind,size,nvars,L,V", [
    ("ring", 30, 30, 62, 2), ("torus", 14, 196, 66, 2), ("ring", 10, 10, 60, 4), ("torus", 6, 36, 40, 8),
    ("torus", 10, 100, 800, 16), ("ring", 8, 8, 4, 4), ("ring", 30, 30, 130, 2), ("torus", 4, 16, 1002, 2)])
def test_accumulate_model_equals_reference_statistics(kind, size, nvars, L, V):
    """wl_accumulate's word arithmetic equals the plain version's statistics of
    the state it leaves (one sweep, R = 3), at each word width; V is the
    widest of 16, 8, 4, 2 that divides L (the state's address is aligned)."""
    assert V == max(v for v in (16, 8, 4, 2) if L % v == 0)
    rng = np.random.default_rng(L + nvars)
    R = 3
    s = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), (R, nvars, L)))
    seeds = torch.from_numpy(rng.integers(-(2**31), 2**31, R).astype(np.int32))
    tables = wl.make_tables((kind, size, -1.0), nvars, 0.05 * L, 1.0, 0.1, L)
    x, stats, samples = wl.wl_sweeps_reference(s, seeds, tables, 1, 1, 1)
    assert np.array_equal(_accumulate(x.numpy(), kind, size, V), stats.numpy())
    assert np.array_equal(samples[:, 0].numpy(), x[:, :, 0].numpy())  # the stage: slice 0 of every line


@pytest.mark.skipif(not torch.cuda.is_available(), reason="the multi-launch kernels run only on the card")
def test_launches_per_sweep_on_the_card():
    """The wrappers count LAUNCHES_PER_SWEEP a sweep on a real call of the
    multi-launch route (a 16-ring at L_tau = 800, 3 sweeps)."""
    dev = torch.device("cuda")
    T, n, L = 3, 16, 800
    s = torch.ones((2, n, L), dtype=torch.int8, device=dev)
    seeds = torch.arange(2, dtype=torch.int32, device=dev)
    tables = wl.make_tables(("ring", n, -1.0), n, 40.0, 1.0, 0.0, L, dev)
    before = wl.wl_sweeps.launches
    wl._run_multi(s, seeds, tables, T)
    assert wl.wl_sweeps.launches - before == wl.LAUNCHES_PER_SWEEP * T
    planes = ladder.build_planes("ring", n, n, np.arange(n), (np.arange(n) + 1) % n, np.full(n, -1.0), [40.0, 30.0],
                                 [1.0, 1.0], [0.0, 0.0], L, dev)
    before = ladder.ladder_sweeps.launches
    ladder._run_multi(s, torch.zeros((T, 2), dtype=torch.int32, device=dev), planes, T)
    assert ladder.ladder_sweeps.launches - before == ladder.LAUNCHES_PER_SWEEP * T
