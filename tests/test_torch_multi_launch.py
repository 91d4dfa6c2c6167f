"""The multi-launch route's site and accumulation kernels, as ``wl_site``
and ``wl_accumulate`` in ``csrc/wl.cu`` schedule and compute them, modelled in
numpy, and the launches a sweep.

- A model of the site phases' schedule (``site_phases`` of
  ``csrc/worldline.cuh``, which ``wl_site`` and ``ladder_site`` share): one
  launch a color, ``site_lanes(L)`` threads a time line of the color, 8 pairs
  of slices a thread in registers, parity 0 up the chunks (the odd slice
  before a pair from the same thread, the lane below by a shuffle, the chunk
  below carried, the line's last slice at pair 0), parity 1 down from the
  last chunk (the next even slice from the same thread, the lane above, the
  chunk above carried, pair 0's at the line's last pair), the chunks below
  read again; groups past their row's end computing the row's last line and
  writing nothing; the neighbour sums added as bytes (``__vadd4``) and the
  decision ``u <= thr[15 (s > 0) + 3 ((B + 4) >> 1) + ((a + b + 2) >> 1)]``;
  against ``wl_sweeps_reference``'s four site phases (its cluster phases
  made to flip nothing), on rings and tori at every ``site_lanes`` size,
  2-byte words and a last chunk of one pair.
- A model of the accumulation's word arithmetic: a warp a line, words of V
  bytes (2, 4, 8 or 16), four signed bytes a dp4a, the line's bond products
  with its outgoing partners (ring i + 1; torus y + 1, x + 1), its spin sum,
  and its aligned bonds from the line's bytes against the same bytes shifted
  down one (the next lane's first byte on top, slice 0 after the last);
  against the statistics that ``wl_sweeps_reference`` returns, on rings and
  tori, at L_tau = 2 mod 4 and at each word width.
- A model of ``pt_swap_features``' items and word arithmetic (``csrc/ladder.cu``):
  the union edges in their given order, then the time lines; words of 4 bytes
  (2, the upper half zero, where L_tau % 4 = 2); an edge's dp4a of its two
  lines' words; a line's dp4a with 0x01010101 and with its words shifted
  down a byte, the next word's first byte on top (slice 0 after the last),
  its aligned bonds (L + sum) / 2; the S and A slots summed over the blocks
  that hold a line; against ``swap_features`` on rings and tori, edges in
  and out of site order, at every group size ``feat_lanes`` picks.
- On the card, the launches a sweep: the wrappers' counters advance by
  ``LAUNCHES_PER_SWEEP`` a sweep on a real multi-launch call (skipped without
  CUDA; ``tests/test_torch_wl.py`` holds that the plain version adds none);
  and ``pt_swap_features`` itself, equal to ``swap_features`` bit for bit on
  the ``glass80.pt`` cell's shape, at L_tau = 62, on shuffled edges with one
  that some replicas lack, past ``wl.MAX_LTAU``, and split into chunks of
  replicas, one launch a chunk (skipped without CUDA).

The models are a second copy of the kernels' rules and can drift from the
CUDA source: the kernels run only on the card, where ``chip_smoke.py``
compare-wl and compare-ladder hold them to the plain versions bit for bit.
Tolerance: none; every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pyisingmontecarlo_tpu_torch.ops import ladder, replicas, wl
from pyisingmontecarlo_tpu_torch.ops.lanerng import lane_draw31, make_pos_mix

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


FEAT_THREADS, FEAT_WORDS = 256, 16  # csrc/ladder.cu: kFeatThreads, kFeatWords


def _feat_lanes(L, V):
    """csrc/ladder.cu's feat_lanes: the threads an item of pt_swap_features."""
    if L > wl.MAX_LTAU:
        return FEAT_THREADS
    need, g = -(-(L // V) // FEAT_WORDS), 1
    while g < need and g < 32:
        g *= 2
    return g


def _ladder_edges(kind, size, rng=None):
    """The union edges of a ring or torus as [E] int32 arrays; with ``rng``,
    shuffled out of site order and about half of them flipped (b, a)."""
    n = size if kind == "ring" else size * size
    v = np.arange(n)
    if kind == "ring":
        ea, eb = v, (v + 1) % n
    else:
        x, y = v // size, v % size
        ea = np.repeat(v, 2)
        eb = np.stack([((x + 1) % size) * size + y, x * size + (y + 1) % size], 1).reshape(-1)
    if rng is not None:
        order, flip = rng.permutation(len(ea)), rng.random(len(ea)) < 0.5
        ea, eb = np.where(flip, eb, ea)[order], np.where(flip, ea, eb)[order]
    return ea.astype(np.int32), eb.astype(np.int32)


def _feature_model(x, ea, eb):
    """feat [R, E + 2] of x [R, nvars, L] int8 as pt_swap_features computes it."""
    R, n, L = x.shape
    E, V = len(ea), 2 if L % 4 else 4
    items = FEAT_THREADS // _feat_lanes(L, V)
    u = x.view(np.uint8).astype(np.uint32)
    words = sum(u[:, :, j::V] << (8 * j) for j in range(V))  # [R, n, L / V]; V = 2: the upper half zero
    nxt = u[:, :, np.r_[V:L:V, 0]]  # the next word's first byte, slice 0 after the last word
    up = (words >> 8) | (nxt << (8 * (V - 1)))

    def dp4a_sum(a, b):  # over a line's words
        return _dp4a(a, b, np.zeros(np.broadcast(a, b).shape, np.int64)).sum(-1)

    P = np.stack([dp4a_sum(words[:, a], words[:, b]) for a, b in zip(ea, eb)], 1)
    S_line = dp4a_sum(words, np.uint32(0x01010101))
    A_line = (L + dp4a_sum(words, up)) // 2
    # the blocks that hold a line (the others return before the block sums): each line once
    summed = np.zeros(n, np.int64)
    for blk in range(-(-(E + n) // items)):
        if (blk + 1) * items > E:
            k = np.arange(blk * items, (blk + 1) * items)
            summed[k[(k >= E) & (k < E + n)] - E] += 1
    assert (summed == 1).all()
    return np.concatenate([P, (S_line * summed).sum(1, keepdims=True), (A_line * summed).sum(1, keepdims=True)], 1)


@pytest.mark.parametrize("kind,size,L,shuffled", [
    ("torus", 6, 60, False), ("torus", 6, 60, True), ("ring", 30, 62, False), ("torus", 4, 8, False),
    ("ring", 8, 4, False), ("ring", 8, 6, True), ("torus", 6, 66, True), ("ring", 10, 300, True),
    ("ring", 6, 1000, False), ("ring", 6, 514, False), ("ring", 4, 4100, False)])
def test_feature_model_equals_swap_features(kind, size, L, shuffled):
    """pt_swap_features' items, words and sums equal swap_features on random
    states (R = 3): group sizes 1 (L_tau = 4, 6, 8, 60), 2 (62), 4 (66), 8
    (300), 16 (1000), 32 (514) and the block (4100); 2-byte words at 6, 62,
    66 and 514; edges shuffled and flipped. A model, not the kernel: the card
    tests below and chip_smoke.py's compare-ladder hold the kernel."""
    assert _feat_lanes(L, 2 if L % 4 else 4) == {4: 1, 6: 1, 8: 1, 60: 1, 62: 2, 66: 4, 300: 8, 1000: 16, 514: 32,
                                                  4100: FEAT_THREADS}[L]
    rng = np.random.default_rng(L + size)
    ea, eb = _ladder_edges(kind, size, rng if shuffled else None)
    n = size if kind == "ring" else size * size
    x = rng.choice(np.array([-1, 1], np.int8), (3, n, L))
    want = ladder.swap_features(torch.from_numpy(x), torch.from_numpy(ea).long(), torch.from_numpy(eb).long())
    got = _feature_model(x, ea, eb)
    assert np.array_equal(got[:, :-2], want[0].numpy())
    assert np.array_equal(got[:, -2], want[1].numpy()) and np.array_equal(got[:, -1], want[2].numpy())


SITE_PAIRS, SITE_THREADS = 8, 128  # csrc/worldline.cuh: kSitePairs, kSiteThreads


def _site_lanes(L):
    """csrc/worldline.cuh site_lanes: the fewest of 4, 8, 16, 32 threads that hold a line of L slices in one chunk."""
    need = -(-(L // 2) // SITE_PAIRS)
    return next((w for w in (4, 8, 16) if need <= w), 32)


def _site_launch(mem, seeds, thr, kind, size, ctr, color):
    """One wl_site launch of ``color`` on mem [R, nvars, L] int8, in place, as
    its thread groups run it: registers e, o [R, groups, W, C] a chunk,
    shuffles as shifts along the lanes, carries across chunks."""
    R, nvars, L = mem.shape
    C, P, W = SITE_PAIRS, L // 2, _site_lanes(L)
    N = W * C
    last = 0 if W < 32 else (P - 1) // N * N  # the last chunk's first pair
    torus = kind == "torus"
    per_row, rows = (size // 2, size) if torus else (nvars // 2, 1)
    lines = SITE_THREADS // W  # lines a block
    jr = np.arange(-(-per_row // lines) * lines)  # every group of a row, past its end too
    live = np.tile(jr < per_row, rows)
    x = np.repeat(np.arange(rows), len(jr))
    y = 2 * np.tile(np.minimum(jr, per_row - 1), rows) + ((x + color) & 1 if torus else color)
    i = x * size + y if torus else y  # [G] the groups' lines
    if torus:
        nb = [((x + 1) % size) * size + y, ((x - 1) % size) * size + y, x * size + (y + 1) % size,
              x * size + (y - 1) % size]
    else:
        nb = [(y + 1) % nvars, (y - 1) % nvars]
    lane = np.arange(W)
    kc = C * lane[:, None] + np.arange(C)[None, :]  # [W, C] a thread's pairs, from the chunk's first
    r = np.arange(R)[:, None, None, None]
    seed = torch.from_numpy(seeds.astype(np.int32))[:, None, None, None]

    def load(b):
        """Registers e, o and the neighbour sums at both slices of pairs k = b + kc, +1 and 0 past the line."""
        k = b + kc
        inside = k < P
        s2 = np.minimum(2 * k, L - 2)
        e = np.where(inside, mem[r, i[:, None, None], s2], 1).astype(np.int64)
        o = np.where(inside, mem[r, i[:, None, None], s2 + 1], 1).astype(np.int64)
        sums = []
        for p in (0, 1):  # byte adds of the neighbour lines, as __vadd4
            u = sum(mem[r, q[:, None, None], s2 + p].view(np.uint8).astype(np.int64) for q in nb) % 256
            sums.append(np.where(inside, u.astype(np.uint8).view(np.int8), 0).astype(np.int64))
        return e, o, sums

    def flips(sv, a, bb, B, k, parity):
        tau = torch.from_numpy(2 * k + parity)
        pos1, pos2 = make_pos_mix(tau[None, None], torch.from_numpy(i)[None, :, None, None], nvars)
        u = lane_draw31(seed, pos1, pos2, ctr + parity).numpy()
        return u <= thr[15 * (sv > 0) + 3 * ((B + 4) >> 1) + ((a + bb + 2) >> 1)]

    def write(k, flip, p, v):
        """Store v at slice 2k + p where flip, on a live group's line, k inside the line."""
        ok = flip & live[None, :, None, None] & (k < P)
        rr, gg, ww, cc = np.nonzero(ok)
        mem[rr, i[gg], 2 * k[ww, cc] + p] = v[ok].astype(np.int8)

    before, first = mem[:, i, L - 1].astype(np.int64), None  # [R, G]
    b = 0
    while True:  # parity 0, up the chunks
        e, o, (Be, Bo) = load(b)
        k = b + kc
        below = np.concatenate([o[:, :, :1, C - 1], o[:, :, :-1, C - 1]], 2)  # __shfl_up by one, lane 0 its own
        po = np.concatenate([np.where(lane == 0, before[:, :, None], below)[..., None], o[..., :-1]], 3)
        flip = flips(e, o, po, Be, k, 0)
        write(k, flip, 0, -e)
        e = np.where(flip & live[None, :, None, None] & (k < P), -e, e)
        if b == 0:
            first = e[:, :, 0, 0]
        if b == last:
            break
        before = o[:, :, W - 1, C - 1]
        b += N
    after = first
    b = last
    while True:  # parity 1, down the chunks
        k = b + kc
        above = np.concatenate([e[:, :, 1:, 0], e[:, :, -1:, 0]], 2)  # __shfl_down by one, the last lane its own
        ne = np.concatenate([e[..., 1:], np.where(lane == W - 1, after[:, :, None], above)[..., None]], 3)
        ne = np.where(k + 1 == P, first[:, :, None, None], ne)
        write(k, flips(o, ne, e, Bo, k, 1), 1, -o)
        if b == 0:
            break
        after = e[:, :, 0, 0]
        e, o, (Be, Bo) = load(b - N)
        b -= N


@pytest.mark.parametrize("kind,size,nvars,L", [
    ("ring", 30, 30, 62), ("torus", 14, 196, 66), ("ring", 10, 10, 130), ("torus", 10, 100, 514),
    ("torus", 6, 36, 800), ("ring", 8, 8, 1002), ("torus", 4, 16, 130), ("ring", 12, 12, 514)])
def test_site_schedule_model_equals_reference_site_phases(kind, size, nvars, L):
    """Two launches a sweep, one a color, on the shared site schedule, equal
    the plain version's four site phases over two sweeps (R = 2; counters
    8 t + 2 color + parity), its cluster phases flipping nothing (no bond
    frozen, a dE no draw's log is below). The cases hold every site_lanes
    size (4 at L_tau = 62, 8 at 66, 16 at 130, 32 and two or more chunks
    from 514), rows past their groups' end, and a last chunk of one pair
    (L_tau = 514)."""
    rng = np.random.default_rng(L + nvars)
    R, T = 2, 2
    s = rng.choice(np.array([-1, 1], np.int8), (R, nvars, L))
    seeds = rng.integers(-(2**31), 2**31, R).astype(np.int32)
    tables = wl.make_tables((kind, size, -1.0), nvars, 0.05 * L, 1.0, 0.1, L)
    tables = tables._replace(cde=torch.full((10,), 1e30), pb=0)
    want = wl.wl_sweeps_reference(torch.from_numpy(s), torch.from_numpy(seeds), tables, T)[0].numpy()
    mem = s.copy()
    for t in range(T):
        for color in (0, 1):
            _site_launch(mem, seeds, tables.thr.numpy(), kind, size, 8 * t + 2 * color, color)
    assert (mem != s).mean() > 0.1
    assert np.array_equal(mem, want)


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


def _feature_case(kind, size, R, L, T, shuffled, dev):
    """Random +-1 worldlines, per-sweep seeds [T, R], planes with +-J
    couplings (with ``shuffled``, edge 0 absent, J = 0, from the odd
    replicas) and the union edges as int32 on ``dev``."""
    rng = np.random.default_rng(R * L + size)
    n = size if kind == "ring" else size * size
    ea, eb = _ladder_edges(kind, size, rng if shuffled else None)
    jv = rng.choice([-1.0, 1.0], (R, len(ea)))
    if shuffled:
        jv[1::2, 0] = 0.0
    betas = np.geomspace(0.2, 3.0, R) * L / 60
    planes = ladder.build_planes(kind, size, n, ea, eb, jv, betas, [1.0] * R, [0.0] * R, L, dev)
    s = torch.from_numpy(rng.choice(np.array([-1, 1], np.int8), (R, n, L))).to(dev)
    seeds = torch.from_numpy(rng.integers(-(2**31), 2**31, (T, R)).astype(np.int32)).to(dev)
    return s, seeds, planes, tuple(torch.from_numpy(e).to(dev) for e in (ea, eb))


def _assert_features_equal(feats, x, edges):
    """The kernel's int32 features equal swap_features of the state on the card, bit for bit."""
    want = ladder.swap_features(x, *(e.long() for e in edges))
    for got, w in zip(feats, want):
        assert got.dtype == torch.int32 and got.shape == w.shape
        assert torch.equal(got.long(), w)


@pytest.mark.skipif(not torch.cuda.is_available(), reason="pt_swap_features runs only on the card")
@pytest.mark.parametrize("kind,size,R,L,T,shuffled", [
    ("torus", 80, 64, 60, 2, False),  # the glass80.pt cell: 80^2 +-J torus, 64 rungs, L_tau 60
    ("ring", 30, 3, 62, 2, False),  # L_tau % 4 = 2: 2-byte words
    ("torus", 14, 5, 60, 2, True),  # edges out of site order and flipped, edge 0 absent from the odd replicas
    ("ring", 16, 2, 40_960, 1, False)])  # past wl.MAX_LTAU: a block an item, fk_long_* sweeps
def test_feature_kernel_equals_swap_features_on_the_card(kind, size, R, L, T, shuffled):
    """pt_swap_features, after T sweeps and after none, equals swap_features
    bit for bit, one launch a call; the wrapper takes it on the glass's shape."""
    dev = torch.device("cuda")
    s, seeds, planes, edges = _feature_case(kind, size, R, L, T, shuffled, dev)
    for t in (0, T):
        before = ladder.ladder_sweeps.feature_launches
        x, feats = ladder._run_multi(s, seeds[:t], planes, t, edges=edges)
        torch.cuda.synchronize()
        assert ladder.ladder_sweeps.feature_launches - before == 1
        assert t == 0 or not torch.equal(x, s)
        _assert_features_equal(feats, x, edges)
    if (kind, size) == ("torus", 80):
        launches = (ladder.ladder_sweeps.resident_launches, ladder.ladder_sweeps.feature_launches)
        x, feats = ladder.ladder_sweeps(s, seeds, planes, T, edges)
        torch.cuda.synchronize()
        assert (ladder.ladder_sweeps.resident_launches, ladder.ladder_sweeps.feature_launches) == \
            (launches[0], launches[1] + 1)
        _assert_features_equal(feats, x, edges)


@pytest.mark.skipif(not torch.cuda.is_available(), reason="pt_swap_features runs only on the card")
def test_feature_launches_a_chunk_on_the_card(monkeypatch):
    """Replicas split into chunks (at most 2 a launch: 2 + 2 + 1 of R = 5)
    take one pt_swap_features launch a chunk, into their rows of one tensor,
    equal to an unsplit call and to swap_features."""
    dev = torch.device("cuda")
    s, seeds, planes, edges = _feature_case("torus", 16, 5, 60, 2, True, dev)
    whole, whole_feats = ladder._run_multi(s, seeds, planes, 2, edges=edges)
    monkeypatch.setattr(replicas, "GRID_MAX", 2)
    before = ladder.ladder_sweeps.feature_launches
    x, feats = ladder._run_multi(s, seeds, planes, 2, edges=edges)
    torch.cuda.synchronize()
    assert ladder.ladder_sweeps.feature_launches - before == 3
    assert torch.equal(x, whole)
    assert all(torch.equal(a, b) for a, b in zip(feats, whole_feats))
    _assert_features_equal(feats, x, edges)
