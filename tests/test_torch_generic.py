"""The port's generic k-local worldline engine (classic route) against the JAX package's.

Tolerance: none for the compile (every array of ``compile_terms``, with and
without ``_and_offset``, with free variables) and for states, keys, samples
and flip deltas; energy sums within 2e-6 and op counts within 1e-5 of the
largest magnitude (f32 sums over the Trotter grid taken in another order). The same numpy-
seeded worldline and threefry keys go through each JAX family function and
its port (site, segment, term-kink, line, slice, free-variable), one whole
``sweep`` with and without ``do_loop``, and the three drivers; the JAX side
runs op by op under ``jax.disable_jit()`` (its classic route takes minutes to
compile), with ``PMC_GENERIC_GM=0`` where a ``GenericWorldline`` chooses. Then
``regrid_worldline``, the key plan of a sweep against the JAX sweep's splits,
and the route gate."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from pyisingmontecarlo_tpu.engines import generic as jge
from pyisingmontecarlo_tpu.rng import keys_from_seeds, split_keys
from pyisingmontecarlo_tpu.utils.accum import kfinal as jkfinal
from pyisingmontecarlo_tpu_torch import rng
from pyisingmontecarlo_tpu_torch.engines import generic as tge
from pyisingmontecarlo_tpu_torch.engines import generic_gm as tgg
from pyisingmontecarlo_tpu_torch.utils.accum import kfinal

torch.set_num_threads(1)

E_RTOL = 2e-6


def zz(j):
    return np.array([j * (1 if (i & 1) else -1) * (1 if (i & 2) else -1) for i in range(4)], np.float64)


def zzz(k):
    return np.array([k * np.prod([1 if (i >> b) & 1 else -1 for b in range(3)]) for i in range(8)], np.float64)


def xx(jx):
    m = np.zeros((4, 4))
    for a in range(4):
        m[a, a ^ 3] = -jx
    return m.reshape(-1)


def xxx(kx):
    m = np.zeros((8, 8))
    for a in range(8):
        m[a, a ^ 7] = -kx
    return m.reshape(-1)


def x1(g):
    return np.array([0.0, -g, -g, 0.0])


# name -> (nvars, [(matrix, vars, diagonal, with_offset)])
TERM_SETS = {
    "tfim": (3, [(zz(-1.0), (0, 1), True, False), (zz(-1.0), (1, 2), True, False)]
             + [(x1(0.8), (i,), False, False) for i in range(3)]),
    "xx+free": (3, [(zz(-1.0), (0, 1), True, False), (x1(0.8), (0,), False, False), (x1(0.8), (1,), False, False),
                    (xx(0.5), (0, 1), False, False)]),
    "zzz": (4, [(zz(-1.0), (i, (i + 1) % 4), True, False) for i in range(4)]
            + [(x1(0.8), (i,), False, False) for i in range(4)] + [(zzz(0.4), (0, 1, 2), True, False)]),
    "xxx": (3, [(xxx(0.5), (0, 1, 2), False, False)] + [(x1(0.6), (i,), False, False) for i in range(3)]),
    "diagonal": (3, [(zz(1.0), (0, 1), True, False), (zz(-0.7), (1, 2), True, False),
                     (np.array([-0.5, 0.5]), (2,), True, False)]),
    "offsets": (4, [(np.array([2.0, -1.0]), (0,), True, True), (np.array([1.0, -0.5, -0.5, 0.25]), (1,), False, True),
                    (zz(-1.0), (1, 2), True, True), (xx(0.5), (1, 2), False, True),
                    (np.diag(zz(0.3)).reshape(-1) + xx(0.2), (0, 1), False, True)]),
    # every family: k = 1, 2 (diagonal and off-diagonal in one class) and 3, kinkless variables, a free variable
    "mixed": (6, [(zz(-1.0), (0, 1), True, False), (zz(-1.0), (1, 2), True, False), (xx(0.5), (0, 1), False, False),
                  (zzz(0.25), (1, 2, 3), True, False), (zz(0.5), (3, 4), True, False)]
              + [(x1(0.9), (i,), False, False) for i in range(3)]),
}


def termsets(name):
    n, terms = TERM_SETS[name]
    a, b = jge.TermSet(n), tge.TermSet(n)
    for mat, vs, diag, off in terms:
        a.add(mat, list(vs), diag, off)
        b.add(mat, list(vs), diag, off)
    return a, b


def _u64(R, seed):
    return np.random.default_rng(seed).integers(0, 2**64, R, dtype=np.uint64)


def _close(got, want, rtol=E_RTOL):
    """Equal to ``rtol`` of the largest magnitude (sums of mixed sign)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1.0), (got, want)


def _equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


@pytest.mark.parametrize("name", sorted(TERM_SETS))
def test_compile_terms_equals_jax(name):
    jts, tts = termsets(name)
    assert jts.offset == tts.offset
    a = jge.compile_terms(jts.nvars, jts.terms, 0.1)
    b = tge.compile_terms(tts.nvars, tts.terms, 0.1)
    assert (a.G, a.nterms, len(a.classes), len(a.tkink)) == (b.G, b.nterms, len(b.classes), len(b.tkink))
    for f in ("touched", "free_vars", "kinkable"):
        _equal(getattr(a, f), getattr(b, f), f)
    for f in ("color_sites", "kink_offs", "kink_cnt"):
        assert len(getattr(a, f)) == len(getattr(b, f))
        for x, y in zip(getattr(a, f), getattr(b, f)):
            _equal(x, y, f)
    for ca, cb in zip(a.classes, b.classes):
        assert (ca.k, ca.diag_only) == (cb.k, cb.diag_only)
        for f in ("vars", "logT", "esti", "group", "term_ids", "pairs"):
            _equal(getattr(ca, f), getattr(cb, f), f)
        for x, y in zip(ca.cvar, cb.cvar):
            _equal(x, y, "cvar")
    for ta, tb in zip(a.tkink, b.tkink):
        for f in ("pvars", "pact", "pgroup", "soffs", "scnt"):
            _equal(getattr(ta, f), getattr(tb, f), f)
        for (s1, p1), (s2, p2) in zip(ta.att, tb.att):
            _equal(s1, s2, "att")
            _equal(p1, p2, "att")
    if name == "xx+free":
        assert list(b.free_vars) == [2] and len(b.tkink) == 1


def test_termset_rejects_what_jax_rejects():
    for args in ((np.ones(3), [0], False, False), (np.zeros(4), [5], False, False), (np.zeros(16), [0, 0], False, False),
                 (np.array([0, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 1, 0, 0, 0.0]), [0, 1], False, False),
                 (np.zeros(3), [0, 1], True, False), (np.zeros(2), [], False, False)):
        for ts in (jge.TermSet(3), tge.TermSet(3)):
            with pytest.raises(ValueError):
                ts.add(*args)


# ------------------------------------------------------------------ families


@pytest.fixture(scope="module")
def mixed():
    """The mixed term set's compile on both sides, a worldline with kinks (10
    port sweeps from a random start, R = 16, then random intervals flipped:
    some of its transfers are forbidden, so the floor bookkeeping counts)
    and keys."""
    jts, tts = termsets("mixed")
    ltau = 6
    jc = jge.compile_terms(jts.nvars, jts.terms, 1.0 / ltau)
    tc = tge.compile_terms(tts.nvars, tts.terms, 1.0 / ltau)
    dt = tge.device_terms(tc, "cpu")
    R = 16
    kd = rng.key_data_from_seeds(_u64(R, 3))
    s0 = torch.from_numpy(rng.random_states(kd, tts.nvars))[:, :, None].expand(-1, -1, ltau * tc.G).contiguous()
    s, keys, _ = tge.run_sweeps(dt, s0, rng.key_tensor(kd, "cpu"), 10, ltau, True, 0.0)
    assert int((s != s.roll(-1, 2)).sum()) > 0
    r = np.random.default_rng(5)
    Lt = s.shape[2]
    for _ in range(3 * R):
        rr, v, l0, ln = r.integers(R), r.integers(tts.nvars), r.integers(Lt), r.integers(1, Lt)
        s[rr, v, torch.from_numpy((np.arange(Lt) - l0) % Lt < ln)] *= -1
    return dict(jc=jc, tc=tc, dt=dt, s=s, ltau=ltau, R=R, u64=_u64(R, 4))


def _sub_keys(u64):
    """JAX's (keys, sub) after one split, and the port's sub key data."""
    keys, sub = split_keys(keys_from_seeds(u64))
    return sub, np.asarray(jax.random.key_data(sub))


def _fan(kd, m):
    out = []
    for _ in range(m):
        kd, k = rng.split_all(kd)
        out.append(rng.seeds_from_key_data(k))
    return torch.from_numpy(np.stack(out))


FAMILIES = ["site c0 p0", "site c1 p1", "segment", "term_kink", "line c0", "line c2", "slice c1", "free"]


@pytest.mark.parametrize("family", FAMILIES)
def test_family_equals_jax(mixed, family):
    jc, tc, dt, s, ltau = mixed["jc"], mixed["tc"], mixed["dt"], mixed["s"], mixed["ltau"]
    sub, kd = _sub_keys(mixed["u64"])
    seed = torch.from_numpy(rng.seeds_from_key_data(kd))
    sj = jnp.asarray(s.numpy())
    with jax.disable_jit():
        if family.startswith("site"):
            c, p = int(family[6]), int(family[9])
            want = jge.site_color_update(jc, sj, sub, c, p)
            got = tge.site_color_update(dt, s.clone(), seed, c, p)
        elif family == "segment":
            want, _ = jge.segment_color_update(jc, sj, sub)
            got = tge.segment_color_update(dt, s.clone(), _fan(kd, len(tc.color_sites)))
        elif family == "term_kink":
            want, _ = jge.term_kink_update(jc, sj, sub, ltau)
            got = tge.term_kink_update(dt, s.clone(), _fan(kd, len(tc.tkink)), ltau)
        elif family.startswith("line"):
            c = int(family[6])
            want = jge.line_color_update(jc, sj, sub, c)
            got = tge.line_color_update(dt, s.clone(), seed, c)
        elif family.startswith("slice"):
            c = int(family[7])
            want = jge.slice_color_update(jc, sj, sub, c, ltau)
            ku, ksel = rng.split_all(kd)
            tau = torch.from_numpy(rng.randint(ksel, ltau))
            got = tge.slice_color_update(dt, s.clone(), torch.from_numpy(rng.seeds_from_key_data(ku)), tau, c)
        else:
            want = jge.free_var_update(jc, sj, sub)
            bits = (rng.random_bits(kd, len(tc.free_vars)) < np.uint32(1 << 31)).T.astype(np.int32)
            got = tge.free_var_update(dt, s.clone(), torch.from_numpy(bits))
    want = np.asarray(want)
    assert (want != s.numpy()).any(), "the move changed nothing: no test"
    _equal(got.numpy(), want, family)


def test_deltas_and_estimators_equal_jax(mixed):
    """Per-site flip deltas bit for bit; total energy, op counts and log weight
    to f32 rounding of their sums."""
    jc, dt, s, ltau = mixed["jc"], mixed["dt"], mixed["s"], mixed["ltau"]
    sj = jnp.asarray(s.numpy())
    with jax.disable_jit():
        for c in range(len(jc.color_sites)):
            sites = jc.color_sites[c]
            s_new = s.clone()
            s_new[:, torch.from_numpy(sites.astype(np.int64))] *= -1
            want = jge._flip_delta_per_site(jc, sj, jnp.asarray(s_new.numpy()), c)
            _equal(tge._flip_delta_per_site(dt, s, s_new, c).numpy(), want, f"flip deltas color {c}")
        e_j = np.asarray(jge.total_energy(jc, sj, ltau, 1.25))
        offs = np.linspace(0.5, 1.5, jc.nterms).astype(np.float32)
        oc_j = np.asarray(jge.term_op_counts(jc, sj, ltau, 0.7, offs))
        lw_j = np.asarray(jge.log_weight(jc, sj))
    _close(tge.total_energy(dt, s, ltau, 1.25).numpy(), e_j)
    _close(tge.term_op_counts(dt, s, ltau, 0.7, offs).numpy(), oc_j, 1e-5)
    _close(tge.log_weight(dt, s).numpy(), lw_j, 1e-6)


@pytest.mark.parametrize("do_loop", [False, True])
def test_sweep_and_key_plan_equal_jax(mixed, do_loop):
    """One sweep from the chain's row equals the JAX sweep, whose splits of
    the replica's key the plan reproduces (keys after the sweep equal)."""
    jc, tc, dt, s, ltau = mixed["jc"], mixed["tc"], mixed["dt"], mixed["s"], mixed["ltau"]
    u64 = mixed["u64"]
    with jax.disable_jit():
        want, keys = jge.sweep(jc, jnp.asarray(s.numpy()), keys_from_seeds(u64), ltau, do_loop)
    plan = tge.sweep_plan(tc, ltau, do_loop)
    seeds, v0, kd = rng.threefry_chain(rng.key_tensor(rng.key_data_from_seeds(u64), "cpu"), plan, 1, 1)
    got = tge.sweep(dt, s.clone(), seeds[0], v0[0], ltau, do_loop)
    _equal(got.numpy(), np.asarray(want), "sweep")
    _equal(rng.key_data_of(kd), np.asarray(jax.random.key_data(keys)), "keys")


# ------------------------------------------------------------------ drivers


@pytest.fixture(scope="module")
def pair():
    """The xx+free pair (G = 3, one term-kink color, a free variable) on both
    sides at beta 1: R = 3 from random classical starts."""
    jts, tts = termsets("xx+free")
    beta, R = 1.0, 3
    u64 = _u64(R, 9)
    kd = rng.key_data_from_seeds(u64)
    s0 = rng.random_states(kd, tts.nvars)
    tw = tge.GenericWorldline(tts, beta, kd, s0, False, device="cpu")
    comp = jge.compile_terms(jts.nvars, jts.terms, tw.dtau)
    return dict(jts=jts, tw=tw, comp=comp, s=np.asarray(tw.s), u64=u64)


@pytest.mark.parametrize("driver,do_loop", [("run_sweeps", False), ("run_sweeps_sample", True),
                                            ("run_sweeps_bond_sample", False)])
def test_driver_equals_jax(pair, driver, do_loop):
    tw, comp, s, u64 = pair["tw"], pair["comp"], pair["s"], pair["u64"]
    off, ltau = 0.125, tw.ltau
    args = {"run_sweeps": (2,), "run_sweeps_sample": (3, 2), "run_sweeps_bond_sample": (2, 1)}[driver]
    extra = (tw.offsets_t, np.float32(tw.beta)) if driver == "run_sweeps_bond_sample" else ()
    with jax.disable_jit():
        want = getattr(jge, driver)(comp, jnp.asarray(s), keys_from_seeds(u64), *args, ltau, do_loop, jnp.float32(off),
                                    *[jnp.asarray(x) for x in extra])
    got = getattr(tge, driver)(tw.dt, torch.from_numpy(s), rng.key_tensor(rng.key_data_from_seeds(u64), "cpu"), *args,
                               ltau, do_loop, off, *extra)
    _equal(got[0].numpy(), np.asarray(want[0]), "state")
    _equal(rng.key_data_of(got[1]), np.asarray(jax.random.key_data(want[1])), "keys")
    _close(kfinal(got[2]), jkfinal(want[2]))
    if driver == "run_sweeps_sample":
        _equal(got[3].numpy(), np.asarray(want[3]), "samples")
    elif driver == "run_sweeps_bond_sample":
        _close(got[3].numpy(), np.asarray(want[3]), 1e-5)


def test_driver_pieces_give_one_trajectory(pair, monkeypatch):
    """PMC_STEPS_PER_DISPATCH cuts the key chain into pieces; any cut gives the same run."""
    tw, s, u64 = pair["tw"], torch.from_numpy(pair["s"]), pair["u64"]
    keys = rng.key_tensor(rng.key_data_from_seeds(u64), "cpu")
    whole = tge.run_sweeps_sample(tw.dt, s, keys, 5, 2, tw.ltau, True, 0.0)
    monkeypatch.setenv("PMC_STEPS_PER_DISPATCH", "2")
    cut = tge.run_sweeps_sample(tw.dt, s, keys, 5, 2, tw.ltau, True, 0.0)
    for a, b in zip((whole[0], whole[1], whole[3]), (cut[0], cut[1], cut[3])):
        assert torch.equal(a, b)


def test_regrid_worldline_equals_jax(mixed):
    """Regrid the mixed set's kinked worldline onto a recompiled grid (one
    more term, another Lt): nearest-slice resample and kink repair agree."""
    s = mixed["s"].numpy()
    jts, tts = termsets("mixed")
    jts.add(zz(0.5), [0, 2], True, False)
    tts.add(zz(0.5), [0, 2], True, False)
    jc = jge.compile_terms(jts.nvars, jts.terms, 0.125)
    tc = tge.compile_terms(tts.nvars, tts.terms, 0.125)
    for Lt in (jc.G * 8, jc.G * 5):
        got = tge.regrid_worldline(s, tc, Lt)
        _equal(got, jge.regrid_worldline(jnp.asarray(s), jc, Lt), f"regrid to Lt {Lt}")
        kink = got != np.roll(got, -1, axis=2)
        assert not (kink & ~tc.kinkable[:, np.arange(Lt) % tc.G][None]).any()


@pytest.mark.parametrize("mode,want", [("0", False), ("1", True), ("auto", True)])
def test_gm_gate_equals_jax(monkeypatch, mode, want):
    from pyisingmontecarlo_tpu.engines import generic_gm as jgg

    monkeypatch.setenv("PMC_GENERIC_GM", mode)
    jts, tts = termsets("zzz")
    a = jge.compile_terms(jts.nvars, jts.terms, 0.1)
    b = tge.compile_terms(tts.nvars, tts.terms, 0.1)
    assert tgg.gm_eligible(b, 4) == jgg.gm_eligible(a, 4) == want
    monkeypatch.setenv("PMC_GM_MAX", str(a.G * 4 * a.nterms - 1))
    assert tgg.gm_eligible(b, 4) == jgg.gm_eligible(a, 4) == (mode == "1")


def test_worldline_grid_equals_jax():
    """GenericWorldline's Trotter grid (ltau, dtau, Lt) and route for a few
    betas and dtau targets, without running the JAX drivers."""
    os.environ.pop("PMC_DTAU", None)
    for name in ("tfim", "zzz", "offsets"):
        jts, tts = termsets(name)
        for beta, dtau in ((1.0, None), (2.5, 0.05), (0.3, None)):
            R = 2
            kd = rng.key_data_from_seeds(_u64(R, 1))
            s0 = np.ones((R, tts.nvars), np.int8)
            a = jge.GenericWorldline(jts, beta, keys_from_seeds(_u64(R, 1)), jnp.asarray(s0), False, dtau_target=dtau)
            b = tge.GenericWorldline(tts, beta, kd, s0, False, dtau_target=dtau, device="cpu")
            assert (a.ltau, a.dtau, a.Lt, a.use_gm) == (b.ltau, b.dtau, b.Lt, b.use_gm)
            _equal(b.offsets_t, a.offsets_t, "offsets")
