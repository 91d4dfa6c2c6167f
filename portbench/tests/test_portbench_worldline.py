"""The worldline cell on the CPU: its plain reference against the program's
plain version bit for bit, the cluster rule it shares with the tempering
reference, its bfloat16 control, its work count by hand, its span and
roofline readers on synthetic windows, and whole tiny runs: sound ones
correct, ones with the timed path broken underneath not correct."""

import math
import time

import numpy as np
import pytest
import torch

from pb_tiny import tiny_copy

from portbench import controls, core, tracing
from portbench.reference import counts, inputs, tempering, wl_counts, worldline
from portbench.reference import threefry as tf
from portbench.tracing import TraceView

CELL = "tfim2d256.tiled"
SEED = 2**31 + 4242


@pytest.mark.parametrize("side,R,beta,ltau,T", [(8, 3, 0.4, 8, 7), (8, 2, 2.0, 40, 12), (16, 2, 0.4, 8, 3),
                                                 (16, 3, 2.0, 40, 4)])
@pytest.mark.parametrize("seed", [2**31 + 11, 2**40 + 3])
def test_reference_against_the_program(side, R, beta, ltau, T, seed):
    from pyisingmontecarlo_tpu_torch import Lattice

    lat = Lattice(inputs.edge_list(*inputs.torus_edges(side), -1.0), seed_gen=seed, dtau=0.05, device="cpu")
    lat.set_transverse_field(1.0)
    gen = np.random.Generator(np.random.PCG64(seed))
    for _ in range(2):
        es, ss = lat.run_quantum_monte_carlo(beta, T, R)
        rs, re = worldline.run(tf.master_seeds(gen, R), side, -1.0, 0.0, 1.0, beta, ltau, T, "cpu")
        assert np.array_equal(rs, ss) and np.array_equal(re, es)


def test_tables_against_the_program():
    from pyisingmontecarlo_tpu_torch.ops import wl

    for beta, gamma, L in ((2.0, 1.0, 40), (0.4, 1.0, 8), (3.0, 0.5, 60)):
        t = wl.make_tables(("torus", 8, -1.0), 64, beta, gamma, 0.25, L)
        thr, cde, pb = worldline.tables(-1.0, 0.25, beta, gamma, L)
        assert torch.equal(thr, t.thr) and torch.equal(cde, t.cde) and pb == t.pb


def test_fk_flips_is_the_programs_rule():
    from pyisingmontecarlo_tpu_torch.ops import wl

    g = torch.Generator().manual_seed(5)
    for L in (4, 7, 32, 40, 33, 130):
        active = (torch.rand((3, 6, L), generator=g) < 0.9).to(torch.int32)
        active[0, 0] = 1  # a line frozen whole
        de = torch.randn((3, 6, L), generator=g) * 0.3
        log_u = torch.log(torch.rand((3, 6, L), generator=g))
        assert torch.equal(tempering.fk_flips(active, de, log_u), wl.fk_flips(active, de, log_u))
        assert torch.equal(tempering.xla_sum_last(de), wl.xla_sum_last(de))


def test_bfloat16_reference_differs():
    seeds = tf.master_seeds(np.random.Generator(np.random.PCG64(SEED)), 3)
    f32 = worldline.run(seeds, 16, -1.0, 0.0, 1.0, 2.0, 40, 6, "cpu")
    bf16 = worldline.run(seeds, 16, -1.0, 0.0, 1.0, 2.0, 40, 6, "cpu", torch.bfloat16)
    assert not np.array_equal(f32[0], bf16[0]) and not np.array_equal(f32[1], bf16[1])


def test_reference_refuses_a_rekeyed_call():
    with pytest.raises(ValueError):
        worldline.run(np.array([1], np.uint64), 8, -1.0, 0.0, 1.0, 2.0, 40, 2**23 // 80 + 1, "cpu")


def test_wl_need_by_hand():
    assert wl_counts.WL_SITE_OPS == 15 + 1
    assert wl_counts.WL_SLICE_OPS == 15 + 3
    assert wl_counts.WL_HEAD_OPS == 15 + 3 + 2 + 1
    # 2 replicas of 4 sites and 4 slices, 3 sweeps, 5 heads a sweep: 32 spins
    nbytes, ops = wl_counts.wl_need(2, 4, 4, 3, 5)
    assert nbytes == 3 * 2 * 32
    assert ops == 3 * (32 * (16 + 18) + 5 * 21)


def _view(host=(), device=(), calls=2, sweeps=2000, counters=None, info=None):
    return TraceView(list(device), list(host), (0.0, 1e6), calls, {"sweeps": sweeps}, counters or {}, info or {})


def _read(metric, view):
    return core.load_module("metrics", metric).read(view)


def test_roofline_reads_the_kernel_against_its_need():
    info = {"R": 8, "nvars": 65536, "L": 40, "T": 1000, "heads_per_sweep": 1e6}
    # 3 launches recorded of 2000 counted, 360 us each: 0.72 s of wl_tiled
    device = [("wl_tiled(signed char const*, ...)", k * 1000.0, k * 1000.0 + 360.0) for k in range(3)]
    device.append(("Memcpy DtoH", 5000.0, 5100.0))
    v = _view(device=device, counters={"wl_sweeps.tiled_launches": 2000}, info=info)
    need = wl_counts.wl_need(8, 65536, 40, 2000, 1e6)
    assert _read("wl_tiled_roofline_pct", v) == pytest.approx(100 * counts.least_s(*need) / 0.72)
    assert _read("wl_tiled_roofline_pct", _view(device=device[3:], counters={"wl_sweeps.tiled_launches": 2000},
                                                info=info)) is None


@pytest.mark.parametrize("metric,span", [("wl_setup_host_ms_per_call.tfim", "pmc.worldline.setup"),
                                         ("wl_states_host_ms_per_call.tfim", "pmc.worldline.states")])
def test_span_metrics(metric, span):
    host = [(tracing.CALL, 0, 5e5), (span, 100, 4100), (tracing.CALL, 5e5, 1e6), (span, 6e5, 6e5 + 2000),
            ("pmc.lattice.states", 0, 9e5)]
    assert _read(metric, _view(host)) == pytest.approx((4000 + 2000) * 1e-3 / 2)
    assert _read(metric, _view(host[:1] + host[2:3] + host[4:])) is None  # a program without the span


def test_heads_are_the_fewest_a_sweep_can_have():
    from pyisingmontecarlo_tpu_torch.ops import wl

    d = core.load_module("drivers", "run_quantum_monte_carlo").Driver(
        core.config("tfim_sq_256") | {"side": 8}, {"timesteps": 2, "num_experiments": 2, "beta": 2.0,
                                                   "check_replicas": 2}, SEED, "cpu")
    i = d.info()
    assert (i["R"], i["nvars"], i["L"], i["T"]) == (2, 64, 40, 2)
    pb = wl.bond_threshold(wl.coupling_params(2.0, 1.0, 40)[2]) / 2147483647.0
    assert i["heads_per_sweep"] == pytest.approx(2 * 64 * 40 * (1 - pb), rel=1e-7)
    assert i["heads_per_sweep"] == pytest.approx(2 * 64 * 40 * math.tanh(0.05))


@pytest.fixture
def here(tmp_path):
    return tiny_copy(tmp_path)


def _run(here, trace=False):
    res, checks, _ = core.run_cell(CELL, SEED, 0.3, trace, "cpu", time.perf_counter(), here=here, root=here.parent)
    return res, checks


def test_tiny_run_traced_reads_its_spans(here):
    res, checks = _run(here, trace=True)
    assert res["correct"] and all(v == 0 for _, v, _ in checks)
    m = res["metrics"]
    assert m["wl_setup_host_ms_per_call.tfim"]["value"] > 0 and m["wl_states_host_ms_per_call.tfim"]["value"] > 0
    assert "wl_tiled_roofline_pct" not in m  # no kernel on the CPU


def _half_batch(fn):
    def broken(s, seeds, tables, T, *args):
        x, stats, samples = fn(s, seeds, tables, T, *args)
        h = s.shape[0] // 2
        return torch.cat([x[:h], s[h:]]), stats, samples
    return broken


def _one_spin(fn):
    def broken(*args):
        x, stats, samples = fn(*args)
        x = x.clone()
        x.view(x.shape[0], -1)[:, 0] *= -1  # slice 0 of site 0, every replica
        return x, stats, samples
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer_altered"])
def test_faults_are_not_correct(here, monkeypatch, fault):
    from pyisingmontecarlo_tpu_torch.ops import wl

    run = wl.wl_sweeps
    broken = {"unchanged": lambda s, seeds, tables, T, *a: run(s, seeds, tables, 0),
              "half_batch": _half_batch(run), "answer_altered": _one_spin(run)}[fault]
    monkeypatch.setattr(wl, "wl_sweeps", broken)
    res, checks = _run(here)
    assert not res["correct"] and any(v > lim for _, v, lim in checks)


def test_control_is_not_correct(here):
    checks = controls.control_checks(CELL, SEED, "cpu", 8, here=here)
    assert any(v > lim for _, v, lim in checks), checks
