"""A numpy model of ``fk_long_sums`` and ``fk_long_apply``
(``pyisingmontecarlo_tpu_torch/csrc/worldline.cuh``), the cluster phase of a
time line too long for one block's shared memory, on one line: which slices
flip, given the frozen bonds, each slice's dE and each slice's log-uniform
(the arguments of ``ops/wl.fk_flips``).

It follows the kernels' data flow, not their threads: segments of ``SEG``
slices, each with a halo of ``HALO`` slices past its end (positions mod L);
a segment's last head published, and the last head before it found from the
segments before it (the look-back); every leaf that starts in a segment
summed from that segment's own copy of the dE (a full one by ``warp_tree``,
the short ones by ``level_sums``), with its two flag bits;
the dE of a slice with no head at or before it (the wrap-around run) kept
for the last block, which sums those leaves or a fully frozen line
(``xla_total``); then each head's and each segment's carried head's
decision from its leaves (``fold``) and each slice's nearest head's
decision. The arithmetic is f32 with numpy's round-to-nearest, the kernels'
``__fadd_rn``. It is a second copy of the algorithm that can drift from the
CUDA source: the kernels run only on the card, where ``chip_smoke.py``
compare-longline holds them to the plain version bit for bit.
"""

import numpy as np

SEG, HALO, LEAF = 1024, 256, 256  # kLongSlices, kLongLeaf slices of halo, kLongLeaf
FOLD_DEPTH = 13  # tree_depth(kLongMaxL / kLongLeaf)
BIG = np.iinfo(np.int64).max


class TreeSum:
    """``TreeSum<depth>`` of ``csrc/worldline.cuh`` on each of ``rows`` rows:
    values fed one at a time (``add``, on the rows of ``live``), blocks
    merged like a binary counter, ``total`` their right-nested sum (onto a
    tail where ``has`` is set)."""

    def __init__(self, rows, depth):
        self.blk = np.zeros((rows, depth), np.float32)
        self.count = np.zeros(rows, np.int64)
        self.depth = depth

    def add(self, v, live=None):
        live = np.ones(len(self.count), bool) if live is None else live
        v = np.asarray(v, np.float32).copy()
        c = self.count
        merges = np.round(np.log2((c ^ (c + 1)) + 1)).astype(np.int64) - 1  # the trailing ones of count
        for b in range(self.depth):
            v = np.where(b < merges, self.blk[:, b] + v, v)
        for b in range(self.depth):
            self.blk[:, b] = np.where(live & (b == merges), v, self.blk[:, b])
        self.count = c + live

    def total(self, tail=None, has=None):
        rows = len(self.count)
        acc = np.zeros(rows, np.float32) if tail is None else np.asarray(tail, np.float32).copy()
        first = np.ones(rows, bool) if has is None else ~has
        for b in range(self.depth):
            bit = (self.count >> b) & 1 == 1
            m = np.where(first, self.blk[:, b], self.blk[:, b] + acc)
            acc = np.where(bit, m, acc)
            first &= ~bit
        return acc


def tree_sums(vals, n, depth):
    """TreeSum's total of the first ``n[k]`` values of each row of ``vals``."""
    ts = TreeSum(len(n), depth)
    for j in range(int(n.max()) if len(n) else 0):
        ts.add(vals[:, j], j < n)
    return ts.total()


def warp_tree(x):
    """A full leaf's sum by a warp (``fk_leaf_tree``): each of 32 lanes sums 8
    slices as a perfect tree, then five levels of ``__shfl_down_sync``, each
    lane adding lane l + o's value (its own past lane 31); lane 0's result."""
    p = np.asarray(x, np.float32).reshape(-1, 32, 8)
    a = p[..., 0::2] + p[..., 1::2]
    b = a[..., 0::2] + a[..., 1::2]
    v = b[..., 0] + b[..., 1]
    for o in (1, 2, 4, 8, 16):
        v = v + np.concatenate([v[:, o:], v[:, 32 - o:]], 1)
    return v[:, 0]


def level_sums(rows, n):
    """Short leaves summed as ``fk_long_sums`` sums them: in place, level by
    level (nodes of 2, 4, ..., 128 slices at multiples of their size within
    the leaf, each the sum of its halves), then the node at each block of
    the binary expansion of ``n[k]`` (the largest node that starts there),
    right-nested from the smallest; per row of ``rows``."""
    v = np.asarray(rows, np.float32).copy()
    r = np.arange(v.shape[1])
    for c in range(1, 8):
        half = 1 << (c - 1)
        node = (r[None] % (2 * half) == 0) & (r[None] + 2 * half <= n[:, None]) & (r[None] + 2 * half <= v.shape[1])
        shifted = np.concatenate([v[:, half:], np.zeros((len(v), half), np.float32)], 1)
        v = np.where(node, v + shifted, v)
    acc = np.zeros(len(n), np.float32)
    first = np.ones(len(n), bool)
    for b in range(8):
        bit = (n >> b) & 1 == 1
        x = v[np.arange(len(n)), np.where(bit, n & ~((2 << b) - 1), 0)]
        acc = np.where(bit, np.where(first, x, x + acc), acc)
        first &= ~bit
    return acc


def xla_total(x):
    """``xla_total``: windows of 32 padded evenly at both ends, each summed
    from +0, level by level while more than 32 terms remain, then the last
    32 or fewer one by one (XLA's CPU order, ``ops/wl.xla_sum_last``)."""
    x = np.asarray(x, np.float32)
    while len(x) > 32:
        m = -(-len(x) // 32)
        pad = np.zeros(32 * m, np.float32)
        lo = (32 * m - len(x)) // 2
        pad[lo:lo + len(x)] = x
        x = np.zeros(m, np.float32)
        for j in range(32):
            x = x + pad[j::32]
    tot = np.float32(0.0)
    for v in x:
        tot = np.float32(tot + v)
    return tot


def fk_long_model(active, de, log_u, stats=None):
    """Which slices of one line ``fk_long_sums`` and ``fk_long_apply`` flip:
    ``active`` [L] (bond (t, t + 1) frozen), ``de`` [L] f32, ``log_u`` [L]
    f32. ``stats``, a dict, gets what the line exercised: short and full
    leaves, the wrap-around leaves, full leaves that end their run, the
    segments whose carried head is the line's last."""
    L = len(active)
    fr = np.asarray(active).astype(bool)
    de = np.asarray(de, np.float32)
    heads = ~np.roll(fr, 1)  # a head after a thawed bond
    nseg = -(-L // SEG)
    S0 = np.arange(nseg, dtype=np.int64) * SEG
    own = np.minimum(SEG, L - S0)
    u = np.arange(SEG + HALO, dtype=np.int64)
    pos = (S0[:, None] + u[None]) % L
    ownm = u[None] < own[:, None]
    hl = heads[pos] & (u[None] < (own + HALO)[:, None])  # a block's head bits, its cover only
    dl = de[pos]  # a block's dE in shared memory
    # fk_long_sums: each segment's last head (its status); the look-back's last head before each segment
    mine = np.where(hl & ownm, u[None], -1).max(1)
    last = np.where(mine >= 0, S0 + mine, -1)
    carry = np.concatenate([[-1], np.maximum.accumulate(last)[:-1]])
    first = np.where(hl & ownm, u[None], BIG).min(1)
    first = np.where(first < BIG, S0 + first, -1)
    # each own slice's head (in the segment, else the carry) and its next head in the cover
    upto = np.maximum.accumulate(np.where(hl, u[None], -1), 1)
    h = np.where(upto >= 0, S0[:, None] + upto, carry[:, None])
    frm = np.minimum.accumulate(np.where(hl, u[None], BIG)[:, ::-1], 1)[:, ::-1]
    nh = np.concatenate([frm[:, 1:], np.full((nseg, 1), BIG)], 1)
    dn = np.where(nh < BIG, nh - u[None], BIG)
    t = S0[:, None] + u[None]
    start = ownm & (h >= 0) & ((t - h) % L % LEAF == 0)
    lf = np.zeros(L, np.float32)
    sw = np.zeros(L, bool)
    ew = np.zeros(L, bool)
    ks, us = np.nonzero(start & (dn < LEAF))
    if len(ks):
        lf[S0[ks] + us] = level_sums(dl[ks[:, None], us[:, None] + np.arange(LEAF)[None]], dn[ks, us])
        sw[S0[ks] + us] = True
        ew[S0[ks] + us] = True
    kf, uf = np.nonzero(start & (dn >= LEAF))
    if len(kf):
        lf[S0[kf] + uf] = warp_tree(dl[kf[:, None], uf[:, None] + np.arange(LEAF)[None]])
        ew[S0[kf] + uf] = dn[kf, uf] == LEAF
    wrap = ownm & (h < 0)
    lf[t[wrap]] = dl[wrap]  # the wrap-around run's dE, for the last block
    # the last block: a fully frozen line, or the wrap-around run's leaves before the first head F
    H = int(last.max())
    if stats is not None:
        stats.update(short=len(ks), full=len(kf), full_ends=int(np.sum(dn[kf, uf] == LEAF)), wrap=0,
                     carried_last=int(np.sum((carry < 0) & ~hl[:, 0])) if H >= 0 else 0)
    if H < 0:
        return np.full(L, log_u[0] < -xla_total(lf))
    F = int(first[first >= 0].min())
    p = np.arange((H - L) % LEAF, F, LEAF)
    if len(p):
        n = np.minimum(LEAF, F - p)
        lf[p] = tree_sums(lf[np.minimum(p[:, None] + np.arange(LEAF)[None], L - 1)], n, 9)
        sw[p] |= n < LEAF
        ew[p] |= F - p <= LEAF
        if stats is not None:
            stats["wrap"] = len(p)
    # fk_long_apply: the heads' decisions and each segment's carried head's, then each slice's nearest head's
    def fold(x):
        x = np.array(x, np.int64)
        ts = TreeSum(len(x), FOLD_DEPTH)
        tail = np.zeros(len(x), np.float32)
        has = np.zeros(len(x), bool)
        live = np.ones(len(x), bool)
        for _ in range(L // LEAF + 1):
            if not live.any():
                break
            v, s, e = lf[x], sw[x], ew[x]
            tail = np.where(live & s, v, tail)
            has |= live & s
            add = live & ~s
            ts.add(v, add)
            live = add & ~e
            x = (x + LEAF) % L
        assert not live.any(), "a run's leaves never ended"
        return ts.total(tail, has)

    hs = np.nonzero(heads)[0]
    dec = np.zeros(L, bool)
    dec[hs] = log_u[hs] < -fold(hs)
    carried = np.where(carry >= 0, carry, H)
    cdec = log_u[carried] < -fold(carried)
    d = np.where(upto >= 0, dec[np.minimum(S0[:, None] + np.maximum(upto, 0), L - 1)], cdec[:, None])
    return d[ownm]
