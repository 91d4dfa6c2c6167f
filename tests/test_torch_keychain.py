"""The graph engines' key chain against jax: ``rng.randint`` against
``jax.random.randint`` (maxval 1 to 10^5 and beyond 2^16, where jax's
multiplier wraps to 0), the lane seeds against ``lanerng.replica_seeds_from_keys``,
and ``threefry_chain_reference`` against the JAX engines' own splits
(``rng.split_keys`` per slot, then the worm's and the cluster update's; the
generic sweep's inner splits of a segment or term-kink pass, a slice's
``randint(ksel, ltau)`` and the free variables' ``bernoulli(sub, 0.5)``; the
tempering swap step's ``uniform(sub, (R,))``) for
plans of every slot kind (tolerance: none); and a numpy model of the CUDA
kernel's split of the work (``csrc/keychain.cu``: a spine warp walking only
``key' = split(key)[0]`` for 32 replicas and staging each key in a ring of
stages, six expansion warps taking batches of slots in turn, splitting off
each slot's sub-key and expanding it into its outputs)
against ``threefry_chain_reference``, for every slot kind. The CUDA kernel is
held to the same numpy version on the card by chip_smoke.py's
compare-keychain and compare-qmcrunner."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from pyisingmontecarlo_tpu.ops import lanerng as jlanerng
from pyisingmontecarlo_tpu.rng import keys_from_seeds, split_keys
from pyisingmontecarlo_tpu_torch import rng

torch.set_num_threads(1)


def _seeds(R, seed):
    return np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64)


@pytest.mark.parametrize("maxval", [1, 2, 3, 7, 36, 100, 2304, 4096, 65535, 65536, 65537, 100000, 2**20 + 3, 0])
def test_randint_equals_jax(maxval):
    u64 = _seeds(64, maxval + 1)
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (), 0, maxval))(keys_from_seeds(u64)))
    np.testing.assert_array_equal(rng.randint(rng.key_data_from_seeds(u64), maxval), want)


def test_randint_covers_one_to_1e5():
    """Every maxval in a sweep from 1 to 10^5, one key each."""
    maxvals = np.unique(np.geomspace(1, 100000, 60).astype(int))
    u64 = _seeds(len(maxvals), 3)
    keys = keys_from_seeds(u64)
    kd = rng.key_data_from_seeds(u64)
    for i, m in enumerate(maxvals):
        want = int(jax.random.randint(keys[i], (), 0, int(m)))
        assert int(rng.randint(kd[i:i + 1], int(m))[0]) == want, m


def test_lane_seeds_equal_replica_seeds_from_keys():
    u64 = _seeds(50, 4)
    keys = keys_from_seeds(u64)
    for _ in range(3):
        keys, sub = split_keys(keys)
    kd = rng.key_data_from_seeds(u64)
    for _ in range(3):
        kd, ksub = rng.split_all(kd)
    np.testing.assert_array_equal(rng.seeds_from_key_data(ksub),
                                  np.asarray(jlanerng.replica_seeds_from_keys(sub)))


def _jax_chain(u64, kinds, T, nvars):
    """The JAX engine's splits of T steps of the plan: (seeds, v0, key data)."""
    keys = keys_from_seeds(u64)
    seeds, v0 = [], []
    for _ in range(T):
        row, worms = [], []
        for kind in kinds:
            keys, sub = split_keys(keys)
            if kind == rng.KEY_PLAIN:
                row.append(jlanerng.replica_seeds_from_keys(sub))
            elif kind == rng.KEY_WORM:
                ku, k0 = split_keys(sub)  # engines/classical._worm_walk
                row.append(jlanerng.replica_seeds_from_keys(ku))
                worms.append(jax.vmap(lambda k: jax.random.randint(k, (), 0, nvars))(k0))
            elif kind == rng.KEY_CLUSTER:
                k1, k_e = split_keys(sub)  # engines/classical.sw_cluster_update
                k2, k_g = split_keys(k1)
                _, k_f = split_keys(k2)
                row += [jlanerng.replica_seeds_from_keys(k) for k in (k_e, k_g, k_f)]
            elif kind[0] == rng.KEY_FAN:
                for _ in range(kind[1]):  # engines/generic.segment_color_update, term_kink_update
                    sub, k1 = split_keys(sub)
                    row.append(jlanerng.replica_seeds_from_keys(k1))
            elif kind[0] == rng.KEY_SLICE:
                ku, ksel = split_keys(sub)  # engines/generic.slice_color_update
                row.append(jlanerng.replica_seeds_from_keys(ku))
                worms.append(jax.vmap(lambda k: jax.random.randint(k, (), 0, kind[1]))(ksel))
            elif kind[0] == rng.KEY_BITS:
                if kind[1]:  # engines/generic.free_var_update
                    bits = jax.vmap(lambda k: jax.random.bernoulli(k, 0.5, (kind[1],)))(sub)
                    worms += list(np.asarray(bits).astype(np.int32).T)
            elif kind[1]:  # tempering's swap step: uniform(sub, (R,)) as f32 bits
                u = jax.vmap(lambda k: jax.random.uniform(k, (kind[1],)))(sub)
                worms += list(np.asarray(u, np.float32).view(np.int32).T)
        seeds.append(np.stack([np.asarray(x) for x in row]) if row else np.zeros((0, len(u64)), np.int32))
        v0.append(np.stack([np.asarray(x) for x in worms]) if worms else np.zeros((0, len(u64)), np.int32))
    return np.stack(seeds), np.stack(v0), np.asarray(jax.random.key_data(keys))


PLANS = [
    ([0, 0, 0, 0, 1], 3, 5, 36),
    ([0, 1, 2, 0], 2, 4, 100003),
    ([2, 2, 1, 1], 2, 3, 70000),
    ([1], 4, 1, 1),
    ([], 3, 4, 10),
    ([0, (3, 4), (3, 1), 0, (5, 0)], 2, 5, 9),
    ([(4, 10), (4, 65537), (5, 7), (3, 0), 1], 3, 4, 12),
    ([0, 0, (3, 5), (3, 5), (3, 4), 0, (4, 1), (4, 2**31 - 1), (5, 40)], 2, 3, 7),
    ([(6, 64)], 3, 1, 1),
    ([(6, 1), 0, (6, 0), (5, 3), (6, 65)], 2, 3, 5),
    ([1, (6, 64), (3, 2), (6, 65), 2], 2, 2, 9),
]


@pytest.mark.parametrize("kinds,T,R,nvars", PLANS)
def test_chain_equals_jax_splits(kinds, T, R, nvars):
    u64 = _seeds(R, T + R)
    want = _jax_chain(u64, kinds, T, nvars)
    got = rng.threefry_chain_reference(rng.key_data_from_seeds(u64), kinds, T, nvars)
    assert rng.chain_columns(kinds) == (got[0].shape[1], got[1].shape[1])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype))


def _block(k, x1):
    """threefry2x32(k, (0, x1)) of [n, 2] keys -> [n, 2]."""
    y0, y1 = rng.threefry2x32(k[:, 0], k[:, 1], np.uint32(0), np.uint32(x1))
    return np.stack([y0, y1], -1)


def _lane_seed(k):
    return (k[:, 0] ^ np.uint32(0x9E3779B9) ^ (k[:, 1] << np.uint32(1))).view(np.int32)


def _randint(k, span):
    """csrc/keychain.cu randint: 32 bits of each half of split(k), jax's arithmetic mod 2^32."""
    hi = np.bitwise_xor.reduce(_block(_block(k, 0), 0), 1).astype(np.uint64)
    lo = np.bitwise_xor.reduce(_block(_block(k, 1), 0), 1).astype(np.uint64)
    span, m32 = np.uint64(span), np.uint64(0xFFFFFFFF)
    mult = np.uint64(65536) % span
    mult = (mult * mult & m32) % span
    return ((((hi % span) * mult & m32) + lo % span & m32) % span).astype(np.int32)


def _expand(sub, kind, param):
    """csrc/keychain.cu expand: a slot's (seed columns, int words) from its sub-keys [32, 2]."""
    if kind == rng.KEY_PLAIN:
        return [_lane_seed(sub)], []
    if kind in (rng.KEY_WORM, rng.KEY_SLICE):
        return [_lane_seed(_block(sub, 0))], [_randint(_block(sub, 1), param)]
    if kind == rng.KEY_CLUSTER:
        k1 = _block(sub, 0)
        return [_lane_seed(_block(sub, 1)), _lane_seed(_block(k1, 1)), _lane_seed(_block(_block(k1, 0), 1))], []
    if kind == rng.KEY_FAN:
        out = []
        for _ in range(param):
            out.append(_lane_seed(_block(sub, 1)))
            sub = _block(sub, 0)
        return out, []
    words = [np.bitwise_xor.reduce(_block(sub, i), 1) for i in range(param)]
    if kind == rng.KEY_BITS:
        return [], [(b < np.uint32(1 << 31)).astype(np.int32) for b in words]
    return [], [(((b >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32) - np.float32(1)).view(np.int32)
                for b in words]


def _chain_model(kd, kinds, T, nvars, warps=6, batch=8, stages=16):
    """threefry_chain_kernel's schedule in numpy: per block of 32 replicas
    (dead lanes past R keyed 0 and never stored), the spine puts a batch of
    the keys it splits into stage g % stages once the batch that held the
    stage was read, computing only each next key; expansion warp e takes
    batches e, e + warps, ... when written, keeping its own place in the plan
    and in the tables (the slot, seed column and int word where its next
    batch starts: the columns of the slots before it, then those of its batch
    and the other warps' batches after each batch), splits each slot's
    sub-key off its staged key and stores the slot's outputs there. The spine runs ahead as far as the ring lets it, then the
    warps take one batch each in turn."""
    plan = [(kind, nvars if kind == rng.KEY_WORM else param) for kind, param in map(rng._slot, kinds)]
    S, J = len(plan), len(plan) * T
    G = -(-J // batch)
    C, W = rng.chain_columns(kinds)
    R = len(kd)
    seeds = np.full((T * C, R), -1, np.int32)
    v0 = np.full((T * W, R), -1, np.int32)
    keys_out = np.empty_like(kd)

    def columns(k, n):  # the seed columns and int words of n slots from slot k on, cyclically
        cw = [rng._slot_columns(*plan[(k + i) % S]) for i in range(n)]
        return sum(c for c, _ in cw), sum(w for _, w in cw)

    for blk in range(0, R, 32):
        live = min(32, R - blk)
        key = np.zeros((32, 2), np.uint32)
        key[:live] = kd[blk:blk + live]
        ring = [None] * stages  # (batch, the keys its slots split) or None once read
        g = 0
        nxt = list(range(warps))  # each expansion warp's next batch
        place = [(e * batch % S, *columns(0, min(J, e * batch))) for e in range(warps)]  # (slot, column, word)
        while g < G or any(n < G for n in nxt):
            while g < G and ring[g % stages] is None:  # the spine, as far as the ring lets it
                staged = []
                for _ in range(g * batch, min(J, g * batch + batch)):
                    staged.append(key)
                    key = _block(key, 0)
                ring[g % stages] = (g, staged)
                g += 1
            for e in range(warps):
                n = nxt[e]
                if n >= G or ring[n % stages] is None or ring[n % stages][0] != n:
                    continue  # not written yet (the stage's parity would make the warp wait)
                k, col, word = place[e]
                for b, staged in enumerate(ring[n % stages][1]):
                    kind, param = plan[(k + b) % S]
                    c, w = columns(k, b)
                    cols, words = _expand(_block(staged, 1), kind, param)
                    for a, v in enumerate(cols):
                        seeds[col + c + a, blk:blk + live] = v[:live]
                    for a, v in enumerate(words):
                        v0[word + w + a, blk:blk + live] = v[:live]
                ring[n % stages] = None
                skip = min(J - n * batch, warps * batch)
                c, w = columns(k, skip)
                place[e] = ((k + skip) % S, col + c, word + w)
                nxt[e] = n + warps
        keys_out[blk:blk + live] = key[:live]
    return seeds.reshape(T, C, R), v0.reshape(T, W, R), keys_out


@pytest.mark.parametrize("kinds,T,R,nvars", [p for p in PLANS if p[0]] + [
    ([0, 1, 2, (3, 0), (3, 1), (3, 3), (4, 9), (5, 0), (5, 5)], 5, 40, 11),
    ([(3, 3), 0, (5, 5), (3, 0), 2, (5, 0), (3, 1), 1, (4, 3)], 20, 70, 100003),
    ([(6, 33)], 60, 1, 1),
])
def test_spine_expansion_model_equals_reference(kinds, T, R, nvars):
    """The kernel's split of the chain (a serial spine, slots expanded beside
    it) writes the reference's tables and keys, for every slot kind (plain,
    worm, cluster, fan with m = 0, 1, 3 and more, slice, bits with m = 0, 5
    and more, uniform with m = 0, 1, 64, 65), blocks with dead lanes (R = 1,
    40, 70), a last batch of fewer slots, and more batches than the ring's
    stages (180 slots; the swap key's 60 uniform slots, one key)."""
    kd = rng.key_data_from_seeds(_seeds(R, 7 * T + R))
    got = _chain_model(kd, kinds, T, nvars)
    want = rng.threefry_chain_reference(kd, kinds, T, nvars)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_chain_continues_across_pieces():
    """Two calls of T1 and T2 steps give the tables of one call of T1 + T2."""
    kd = rng.key_data_from_seeds(_seeds(6, 1))
    kinds = [0, 1, 0, 2]
    whole = rng.threefry_chain_reference(kd, kinds, 5, 50)
    a = rng.threefry_chain_reference(kd, kinds, 2, 50)
    b = rng.threefry_chain_reference(a[2], kinds, 3, 50)
    np.testing.assert_array_equal(np.concatenate([a[0], b[0]]), whole[0])
    np.testing.assert_array_equal(np.concatenate([a[1], b[1]]), whole[1])
    np.testing.assert_array_equal(b[2], whole[2])


def test_wrapper_on_cpu_tensor_launches_nothing():
    kd = rng.key_data_from_seeds(_seeds(7, 2))
    rng.threefry_chain.launches = 0
    seeds, v0, keys = rng.threefry_chain(rng.key_tensor(kd, "cpu"), [0, 1, 2], 4, 33)
    assert rng.threefry_chain.launches == 0
    want = rng.threefry_chain_reference(kd, [0, 1, 2], 4, 33)
    np.testing.assert_array_equal(seeds.numpy(), want[0])
    np.testing.assert_array_equal(v0.numpy(), want[1])
    np.testing.assert_array_equal(rng.key_data_of(keys), want[2])
    assert seeds.dtype == v0.dtype == keys.dtype == torch.int32


def test_generic_sweep_plan_columns():
    """The generic sweep's plan: (C, W) of every slot kind, and a plan with no
    seed column (a lone bits slot) walks its keys."""
    plan = [0, 0, (rng.KEY_FAN, 5), (rng.KEY_FAN, 4), 0, (rng.KEY_SLICE, 10), (rng.KEY_BITS, 3)]
    assert rng.chain_columns(plan) == (2 + 5 + 4 + 1 + 1, 1 + 3)
    assert rng.chain_columns([(rng.KEY_BITS, 0)]) == (0, 0)
    kd = rng.key_data_from_seeds(_seeds(4, 6))
    seeds, v0, out = rng.threefry_chain_reference(kd, [(rng.KEY_BITS, 0)], 3, 1)
    assert seeds.shape == (3, 0, 4) and v0.shape == (3, 0, 4)
    want = kd
    for _ in range(3):
        want, _ = rng.split_all(want)
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("slot", [(rng.KEY_SLICE, 0), (rng.KEY_SLICE, -3), (rng.KEY_SLICE, 2**31), (rng.KEY_FAN, -1),
                                  (rng.KEY_BITS, 2**17), (rng.KEY_PLAIN, 1), (rng.KEY_FAN, 2, 3), 3, 4, 5, 6,
                                  (rng.KEY_UNIFORM, -1), (rng.KEY_UNIFORM, 2**16 + 1), (rng.KEY_UNIFORM, 1, 2), 7,
                                  (7, 4)])
def test_chain_rejects_bad_slots(slot):
    kd = rng.key_tensor(rng.key_data_from_seeds(_seeds(3, 2)), "cpu")
    with pytest.raises(ValueError):
        rng.threefry_chain(kd, [0, slot], 1, 5)
    with pytest.raises(ValueError):
        rng.chain_columns([slot])


def test_wrapper_checks_its_inputs():
    kd = rng.key_tensor(rng.key_data_from_seeds(_seeds(3, 2)), "cpu")
    with pytest.raises(ValueError):
        rng.threefry_chain(kd, [0, 3], 1, 5)
    with pytest.raises(ValueError):
        rng.threefry_chain(kd, [0, 1], 1, 0)
    with pytest.raises(ValueError):
        rng.threefry_chain(kd.to(torch.int64), [0], 1, 5)
    with pytest.raises(ValueError):
        rng.threefry_chain(kd[:, :1], [0], 1, 5)


def test_key_tensor_round_trip():
    kd = rng.key_data_from_seeds(_seeds(9, 8))
    t = rng.key_tensor(kd, "cpu")
    assert t.dtype == torch.int32 and t.shape == (9, 2)
    np.testing.assert_array_equal(rng.key_data_of(t), kd)
