"""The two-launch schedule of the long-line cluster phase
(``fk_long_sums`` and ``fk_long_apply``, ``csrc/worldline.cuh``), in its numpy
model (``fk_long_model.py``), against ``ops/wl.fk_flips``, bit for bit:

- at L_tau = 40,960 and 2^20 (segments of 1024 slices) and at 28,674 and
  250,000 (not multiples of 1024: a short last segment whose halo wraps to
  the line's start), on random lines at densities of frozen bonds from 0.3
  to 0.9999, and on lines built to hit each edge of the schedule: a head on
  a segment's first and on its last slice, a run crossing several segments,
  a full leaf ending exactly at the halo's last slice (and one slice
  before), the wrap-around run with leaves before the line's first head, a
  head on slice 0 and on slice L - 1, a line with one head, a fully frozen
  line;
- a full leaf summed by a warp (8 slices a lane, five shuffle levels)
  against TreeSum fed its 256 slices one at a time, on f32 values of mixed
  magnitude where the order of the additions matters; a short leaf of every
  length from 1 to 255 summed level by level in place and its blocks
  nested, against TreeSum; a run's leaves folded onto its tail against
  TreeSum over the whole run; ``xla_total`` against ``wl.xla_sum_last``.

The model follows the kernels' data flow; the kernels themselves run only on
the card (``chip_smoke.py`` compare-longline, compare-replicas). Tolerance:
none.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from fk_long_model import HALO, LEAF, SEG, TreeSum, fk_long_model, level_sums, tree_sums, warp_tree, xla_total
from pyisingmontecarlo_tpu_torch.ops import wl

torch.set_num_threads(1)


def _values(rng, shape):
    """(de, log_u) as the test lines take them: dE from the worldline's table
    and small normals, log-uniforms of 31-bit draws."""
    table = np.float32([-0.4, -0.2, -0.0, 0.0, 0.2, 0.4, 0.1, -0.1, 0.3, -0.3])
    de = np.where(rng.random(shape) < 0.5, rng.choice(table, shape),
                  0.05 * rng.standard_normal(shape)).astype(np.float32)
    u = (rng.integers(0, 2**31, shape).astype(np.float32) + np.float32(0.5)) * np.float32(2.0**-31)
    return de, np.log(u).astype(np.float32)


def _edge_lines(L, rng):
    """{name: frozen bonds [L] (bond t is (t, t + 1))} of lines built to hit
    each edge of the schedule, on a background of frozen bonds at 0.95."""
    S = 3 * SEG  # a segment's first slice
    out = {}
    a = rng.random(L) < 0.95
    a[S - 1] = a[S + SEG - 2] = False  # heads on slices S and S + 1023
    out["heads on a segment's first and last slice"] = a
    a = rng.random(L) < 0.95
    a[S - 300:S + 3 * SEG + 7] = True  # one run over four segments
    out["a run crossing several segments"] = a
    for end in (SEG + HALO - 1, SEG + HALO - 2):  # the halo's last slice, and the one before it
        a = rng.random(L) < 0.95
        h = S + SEG - 1 - LEAF  # a head whose second leaf starts on the segment's last slice
        a[h:S + end - 1] = True
        a[h - 1] = a[S + end - 1] = False
        out[f"a leaf from the segment's last slice to halo slice {end - SEG}"] = a
    a = rng.random(L) < 0.95
    a[L - 100:] = True
    a[:699] = True
    a[L - 101] = a[699] = False  # the line's last head L - 100, its first 700
    out["the wrap-around run"] = a
    a = rng.random(L) < 0.95
    a[L - 1] = a[L - 2] = False  # heads on slices 0 and L - 1
    out["heads on slices 0 and L - 1"] = a
    a = np.ones(L, bool)
    a[L // 3] = False
    out["one head"] = a
    out["fully frozen"] = np.ones(L, bool)
    return out


def _random_lines(L, rng, densities):
    return {f"random, frozen at {p}": rng.random(L) < p for p in densities}


def _check(L, lines, seed):
    """The model on each line against fk_flips on all of them; returns the
    model's stats by line."""
    names = list(lines)
    active = np.stack([lines[n] for n in names]).astype(np.int32)
    de, log_u = _values(np.random.default_rng(seed), active.shape)
    want = wl.fk_flips(torch.from_numpy(active)[None], torch.from_numpy(de)[None],
                       torch.from_numpy(log_u)[None])[0].numpy()
    stats = {}
    for r, name in enumerate(names):
        stats[name] = {}
        got = fk_long_model(active[r], de[r], log_u[r], stats[name])
        np.testing.assert_array_equal(got, want[r], err_msg=f"L={L}: {name}")
    assert want.any() and not want.all()
    return stats


@pytest.mark.parametrize("L", (40960, 28674, 250000))
def test_two_launch_model_equals_fk_flips_on_edge_lines(L):
    rng = np.random.default_rng(L)
    lines = {**_edge_lines(L, rng), **_random_lines(L, rng, (0.3, 0.9, 0.99, 0.999))}
    stats = _check(L, lines, L + 1)
    assert stats["the wrap-around run"]["wrap"] == 3  # leaves at 156, 412 (full) and 668 (short), before F = 700
    # the leaf from the segment's last slice full, the next head on the halo's last slice
    assert stats["a leaf from the segment's last slice to halo slice 255"]["full_ends"] >= 1
    assert stats["a run crossing several segments"]["full"] >= 12
    assert stats["one head"]["carried_last"] >= 1
    assert stats["random, frozen at 0.9"]["short"] > 0 and stats["random, frozen at 0.999"]["full"] > 0


def test_two_launch_model_equals_fk_flips_at_2_20():
    L = 1 << 20
    rng = np.random.default_rng(7)
    lines = _random_lines(L, rng, (0.95, 0.9999))
    a = np.ones(L, bool)
    a[12345] = False
    lines["one head"] = a
    lines["fully frozen"] = np.ones(L, bool)
    stats = _check(L, lines, 8)
    # the run's 4096 leaves: 4048 from the head at 12,346 (the last one across slice 0), then the wrap-around
    # run's 48 from slice 58 to the head, which the last block sums
    assert stats["one head"]["full"] == 4048 and stats["one head"]["wrap"] == 48


def test_warp_tree_equals_treesum_order():
    rng = np.random.default_rng(3)
    x = (rng.choice([-1.0, 1.0], (64, LEAF)) * 10.0 ** rng.uniform(-8, 8, (64, LEAF))).astype(np.float32)
    seq = tree_sums(x, np.full(64, LEAF), 9)
    np.testing.assert_array_equal(warp_tree(x), seq)
    flat = np.zeros(64, np.float32)
    for j in range(LEAF):
        flat = flat + x[:, j]
    assert (flat != seq).any()  # the order matters on these values


def test_level_sums_equal_treesum_for_every_short_length():
    rng = np.random.default_rng(4)
    n = np.arange(1, LEAF)
    x = (rng.choice([-1.0, 1.0], (len(n), LEAF)) * 10.0 ** rng.uniform(-8, 8, (len(n), LEAF))).astype(np.float32)
    np.testing.assert_array_equal(level_sums(x, n), tree_sums(x, n, 8))


def test_treesum_nests_short_tail_and_xla_total_matches_xla_sum_last():
    rng = np.random.default_rng(5)
    x = (rng.choice([-1.0, 1.0], (40, 700)) * 10.0 ** rng.uniform(-6, 6, (40, 700))).astype(np.float32)
    n = rng.integers(1, 700, 40)
    got = tree_sums(x, n, 10)
    for r in range(40):  # the leaves of 256 folded onto the tail, as fk_long_apply folds them
        q, rest = divmod(int(n[r]), LEAF)
        leaves = warp_tree(x[r, :q * LEAF].reshape(q, LEAF)) if q else np.zeros(0, np.float32)
        ts = TreeSum(1, 13)
        for v in leaves:
            ts.add(np.float32([v]))
        tail = tree_sums(x[r:r + 1, q * LEAF:], np.array([rest]), 8) if rest else np.zeros(1, np.float32)
        assert ts.total(tail, np.array([rest > 0]))[0] == got[r]
    for L in (27000, 40960, 250000):
        y = x.reshape(-1)[:min(L, x.size)] if L <= x.size else rng.standard_normal(L).astype(np.float32)
        assert xla_total(y) == wl.xla_sum_last(torch.from_numpy(y)).item()
