"""The port's group-major route of the generic engine against the JAX package's.

On the hard term mix of tests/test_generic_gm.py (TFIM + XX + ZZZ on an
8-ring: k = 1, 2 and 3 classes, term kinks), with the same numpy-seeded
worldline (sprinkled kinks, some forbidden) and keys on both sides:

- ``compile_gm`` and ``compile_gm_kinks``: every host array, and every
  column subset, equal (tolerance: none);
- the layout round trip, and ``to_gm`` equal to the JAX layout;
- the weight plane within 1e-5; site and total deltas of every color against
  the JAX engine's within atol=3e-4, rtol=1e-4, clamped at +-80, as in
  tests/test_generic_gm.py; energy and op counts within 1e-3;
- whole gm sweeps (one from the worldline, with and without ``do_loop``) and
  the three gm drivers on the small pair set against the JAX gm route (run op
  by op under ``jax.disable_jit()``).

Which case holds for the sweeps: at these sizes torch's CPU matmul gives
XLA's CPU dot bits in every attribution product (the site and total deltas of
every color are equal bit for bit, which this file checks), so the sweeps are
held bit for bit in states, keys and samples, and no Glauber decision lies
within the delta tolerance of its threshold (the file counts them: 0). A
product summed in another order would move a delta by f32 rounding only;
chip_smoke.py's compare-qmcrunner counts such ties on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from pyisingmontecarlo_tpu.engines import generic as jge
from pyisingmontecarlo_tpu.engines import generic_gm as jgg
from pyisingmontecarlo_tpu.rng import keys_from_seeds
from pyisingmontecarlo_tpu.utils.accum import kfinal as jkfinal
from pyisingmontecarlo_tpu_torch import rng
from pyisingmontecarlo_tpu_torch.engines import classical as ce
from pyisingmontecarlo_tpu_torch.engines import generic as tge
from pyisingmontecarlo_tpu_torch.engines import generic_gm as tgg
from pyisingmontecarlo_tpu_torch.utils.accum import kfinal
from test_generic_gm import hard_terms, random_worldline
from test_torch_generic import _close, _equal, termsets

torch.set_num_threads(1)


def _clamp(x):
    # any delta below -80 is acceptance-equivalent (sigmoid == 0 in f32)
    return np.clip(x, -80.0, 80.0)


@pytest.fixture(scope="module")
def hard():
    n, R, lt = 8, 4, 6
    ts = hard_terms(n)
    jc = jge.compile_terms(n, ts.terms, 0.1)
    tc = tge.compile_terms(n, [dict(t) for t in ts.terms], 0.1)
    jgs, tgs = jgg.compile_gm(jc, n), tgg.compile_gm(tc, n)
    s = random_worldline(jc, n, R, lt, seed=3)
    return dict(n=n, R=R, lt=lt, jc=jc, tc=tc, jgs=jgs, tgs=tgs, jk=jgg.compile_gm_kinks(jc, jgs),
                tk=tgg.compile_gm_kinks(tc, tgs), s=s, jgm=jgg.to_gm(jnp.asarray(s), jc.G),
                tgm=tgg.to_gm(torch.from_numpy(s), tc.G))


def test_compile_gm_equals_jax(hard):
    a, b = hard["jgs"], hard["tgs"]
    for f in a.host._fields:
        x, y = getattr(a.host, f), getattr(b.host, f)
        if isinstance(x, np.ndarray):
            _equal(y, x, f)
        elif isinstance(x, tuple) and x and isinstance(x[0], np.ndarray):
            for u, v in zip(x, y):
                _equal(v, u, f)
        else:
            assert x == y, f
    D = b.D
    code = a.host.pairs[:, 0] * D + a.host.pairs[:, 1]
    _equal(b.lut.numpy()[:, code], a.host.tabs, "lut at the union pairs")
    _equal(b.elut.numpy()[:, code], a.host.etabs, "elut at the union pairs")
    for sa, sb in zip(a.csub, b.csub):
        assert sa.Tc == sb.Tc
        _equal(sb.WT.numpy().T, np.asarray(sa.W), "csub W")
        _equal(sb.lut.numpy()[:, code], np.asarray(sa.tabs), "csub tabs")
        _equal(sb.PmPw.numpy(), np.asarray(sa.PmPw), "csub PmPw")
        _equal(sb.A.numpy(), np.asarray(sa.A), "csub A")


def test_compile_gm_kinks_equals_jax(hard):
    code = hard["jgs"].host.pairs[:, 0] * hard["tgs"].D + hard["jgs"].host.pairs[:, 1]
    assert len(hard["jk"]) == len(hard["tk"]) > 0
    for pa, pb in zip(hard["jk"], hard["tk"]):
        assert (pa.P, pa.kmax) == (pb.P, pb.kmax)
        for f in ("pgroup", "soffs", "scnt", "pact", "Satt"):
            _equal(getattr(pb, f), getattr(pa, f), f)
        for u, v in zip(pa.S, pb.S):
            _equal(v, u, "S")
        assert pa.sub.Tc == pb.sub.Tc
        _equal(pb.sub.WT.numpy().T, np.asarray(pa.sub.W), "kink W")
        _equal(pb.sub.lut.numpy()[:, code], np.asarray(pa.sub.tabs), "kink tabs")
        _equal(pb.Satt_sub.numpy(), np.asarray(pa.Satt_sub), "Satt_sub")


def test_layout_round_trip(hard):
    _equal(hard["tgm"].numpy(), np.asarray(hard["jgm"]), "to_gm")
    back = tgg.from_gm(hard["tgm"], hard["tc"].G, hard["n"], hard["R"])
    assert back.dtype == torch.int8
    _equal(back.numpy(), hard["s"], "from_gm")
    _equal(tgg.out_plane(hard["tgm"], hard["tc"].G, hard["n"], hard["R"]).numpy(),
           np.asarray(jgg.out_plane(hard["jgm"], hard["jc"].G, hard["n"], hard["R"])), "out_plane")


def test_weight_plane_matches_jax(hard):
    got = tgg.lw_plane(hard["tgs"], hard["tgm"], hard["R"]).numpy()
    want = np.asarray(jgg.lw_plane(hard["jgs"], hard["jgm"], hard["R"]))
    np.testing.assert_allclose(got, want, atol=1e-5)


def _masks(h, c):
    """(site masks by parity, line mask) of color c on both sides."""
    n, R, lt, G = h["n"], h["R"], h["lt"], h["jc"].G
    crow = jgg._tile_rows(jnp.asarray(h["jgs"].host.color_rows[c])[:, None], G)
    site = [np.asarray(jgg._parity_plane(G, n, lt, R, p) * crow) for p in (0, 1)]
    line = np.asarray(jgg._tile_rows(jnp.broadcast_to(jnp.asarray(h["jgs"].host.color_rows[c])[:, None],
                                                      (n, lt * R)), G))
    return site, line


def test_site_and_total_deltas_match_jax(hard):
    """Every color's site deltas (both parities, full and column-subset forms)
    and line and interval totals within tests/test_generic_gm.py's
    tolerances; and, at these sizes, equal bit for bit (the sweeps' case)."""
    h = hard
    R = h["R"]
    rs = np.random.default_rng(11)
    with ce.exact_f32_matmul():
        for c in range(len(h["jc"].color_sites)):
            site, line = _masks(h, c)
            sub_j, sub_t = h["jgs"].csub[c], h["tgs"].csub[c]
            for m in site:
                mt = torch.from_numpy(m.copy())
                want = np.asarray(jgg._site_deltas_sub(h["jgs"], sub_j, h["jgm"], jnp.asarray(m), R)[0])
                got = tgg._site_deltas_sub(h["tgs"], sub_t, h["tgm"], mt, R)[0].numpy()
                full = tgg.site_deltas(h["tgs"], h["tgm"], mt, R)[0].numpy()
                on = m > 0
                for x in (got, full):
                    np.testing.assert_allclose(_clamp(x[on]), _clamp(want[on]), atol=3e-4, rtol=1e-4)
                _equal(got[on], want[on], f"site deltas color {c}")
            l1 = rs.integers(0, h["lt"] * h["jc"].G, (h["n"], R)).astype(np.float32)
            ln = rs.integers(0, h["lt"] * h["jc"].G, (h["n"], R)).astype(np.float32)
            interval = np.asarray(jgg._interval_mask(h["jgs"], jnp.asarray(l1), jnp.asarray(ln), h["lt"], R)) * line
            _equal(tgg._interval_mask(h["tgs"], torch.from_numpy(l1), torch.from_numpy(ln), h["lt"], R).numpy() * line,
                   interval, "interval mask")
            sites = h["jc"].color_sites[c]
            for m in (line, interval):
                want = np.asarray(jgg._total_deltas_sub(h["jgs"], sub_j, h["jgm"], jnp.asarray(m), R)[0])[sites]
                mt = torch.from_numpy(m.copy())
                got = tgg._total_deltas_sub(h["tgs"], sub_t, h["tgm"], mt, R)[0].numpy()[sites]
                full = tgg.total_deltas(h["tgs"], h["tgm"], mt, R)[0].numpy()[sites]
                for x in (got, full):
                    np.testing.assert_allclose(_clamp(x), _clamp(want), atol=3e-4, rtol=1e-4)
                _equal(got, want, f"total deltas color {c}")


def test_energy_and_op_counts_match_jax(hard):
    h = hard
    R, lt = h["R"], h["lt"]
    e_t = tgg.energy_gm(h["tgs"], h["tgm"], R, lt, 1.25).numpy()
    np.testing.assert_allclose(e_t, np.asarray(jgg.energy_gm(h["jgs"], h["jgm"], R, lt, offset=1.25)), atol=1e-3)
    offs = np.linspace(0.5, 1.5, h["jc"].nterms).astype(np.float32)
    oc_t = tgg.term_op_counts_gm(h["tgs"], h["tgm"], R, lt, 0.7, offs).numpy()
    np.testing.assert_allclose(oc_t, np.asarray(jgg.term_op_counts_gm(h["jgs"], h["jgm"], R, lt, 0.7, offs)), atol=1e-3)
    # the classic route's estimator of the same worldline
    np.testing.assert_allclose(e_t, tge.total_energy(tge.device_terms(h["tc"], "cpu"), torch.from_numpy(h["s"]), lt,
                                                     1.25).numpy(), atol=1e-3)


def _ties(h, c, parity, D, seed):
    """Site decisions of (c, parity) whose delta lies within the tolerance of
    its Glauber threshold: (u < sigmoid(D - tol)) != (u < sigmoid(D + tol))."""
    site, _ = _masks(h, c)
    u = tgg._plane_uniform(seed, h["jc"].G * h["n"], h["lt"], h["R"])
    tol = 3e-4 + 1e-4 * D.abs()
    return int((((u < torch.sigmoid(D - tol)) != (u < torch.sigmoid(D + tol))) & (torch.from_numpy(site[parity].copy()) > 0))
               .sum())


@pytest.mark.parametrize("do_loop", [False, True])
def test_sweep_gm_equals_jax(hard, do_loop):
    h = hard
    R = h["R"]
    u64 = np.random.default_rng(1).integers(0, 2**64, R, dtype=np.uint64)
    with jax.disable_jit():
        want, keys = jgg.sweep_gm(h["jgs"], h["jk"], h["jc"], h["jgm"], keys_from_seeds(u64), R, do_loop)
    plan = tge.sweep_plan(h["tc"], h["lt"], do_loop, gm=True)
    seeds, v0, kd = rng.threefry_chain(rng.key_tensor(rng.key_data_from_seeds(u64), "cpu"), plan, 1, 1)
    with ce.exact_f32_matmul():
        got = tgg.sweep_gm(h["tgs"], h["tk"], h["tgm"].clone(), seeds[0], v0[0], R, do_loop)
        ties = sum(_ties(h, c, p, tgg._site_deltas_sub(h["tgs"], h["tgs"].csub[c], h["tgm"],
                                                        torch.from_numpy(_masks(h, c)[0][p].copy()), R)[0],
                         seeds[0, 2 * c + p])
                   for c in range(len(h["tc"].color_sites)) for p in (0, 1))
    assert ties == 0
    assert (np.asarray(want) != h["tgm"].numpy()).any()
    _equal(got.numpy(), np.asarray(want), "gm sweep")
    _equal(rng.key_data_of(kd), np.asarray(jax.random.key_data(keys)), "keys")


@pytest.mark.parametrize("driver", ["run_sweeps_gm", "run_sweeps_sample_gm", "run_sweeps_bond_sample_gm"])
def test_gm_driver_equals_jax(driver):
    """The pair set (a free variable: the bits slot reads its free row) with do_loop."""
    jts, tts = termsets("xx+free")
    R, beta = 3, 1.0
    u64 = np.random.default_rng(9).integers(0, 2**64, R, dtype=np.uint64)
    kd = rng.key_data_from_seeds(u64)
    tw = tge.GenericWorldline(tts, beta, kd, rng.random_states(kd, 3), True, device="cpu")
    assert tw.use_gm
    jc = jge.compile_terms(3, jts.terms, tw.dtau)
    jgs = jgg.compile_gm(jc, 3)
    jk = jgg.compile_gm_kinks(jc, jgs)
    args = {"run_sweeps_gm": (2,), "run_sweeps_sample_gm": (3, 2), "run_sweeps_bond_sample_gm": (2, 1)}[driver]
    extra = (tw.offsets_t, np.float32(beta)) if driver == "run_sweeps_bond_sample_gm" else ()
    s = tw.s.numpy()
    with jax.disable_jit():
        tables = jgg.detach_tables(jgs, jk)
        want = getattr(jgg, driver)(tables[0], tables[1], jc, tables[2], jnp.asarray(s), keys_from_seeds(u64), *args,
                                    tw.ltau, True, jnp.float32(0.25), *[jnp.asarray(x) for x in extra])
    got = getattr(tgg, driver)(tw.gs, tw.kinks, tw.comp, torch.from_numpy(s), rng.key_tensor(kd, "cpu"), *args,
                               tw.ltau, True, 0.25, *extra)
    _equal(got[0].numpy(), np.asarray(want[0]), "state")
    _equal(rng.key_data_of(got[1]), np.asarray(jax.random.key_data(want[1])), "keys")
    _close(kfinal(got[2]), jkfinal(want[2]))
    if driver == "run_sweeps_sample_gm":
        _equal(got[3].numpy(), np.asarray(want[3]), "samples")
    elif driver == "run_sweeps_bond_sample_gm":
        _close(got[3].numpy(), np.asarray(want[3]), 1e-5)
