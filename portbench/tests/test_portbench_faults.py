"""The check that decides ``correct``, shown to fail: a run driven whole
(set-up, window, check) with the look for a card skipped and the timed path
broken underneath comes out not correct, once for each fault a cell can
have; the controls (the reference in the program's place, in bfloat16) come
out not correct; sound runs come out correct. One card, so no exchange
between chips can be left out."""

import time

import pytest
import torch

from pb_tiny import tiny_copy

from portbench import controls, core

SEED = 2**31 + 777
FERRO, GLASS = "ferro1024.r100", "glass80.pt"


@pytest.fixture
def here(tmp_path):
    return tiny_copy(tmp_path)


def _run(here, cell):
    res, checks, _ = core.run_cell(cell, SEED, 0.3, False, "cpu", time.perf_counter(), here=here,
                                      root=here.parent)
    return res["correct"], checks


def _unchanged(s, *args, **kw):
    return s.clone()


def _half_batch(fn):
    def broken(s, *args, **kw):
        out = fn(s, *args, **kw)
        h = s.shape[0] // 2
        return torch.cat([out[:h], s[h:]]) if h else out
    return broken


def _one_spin(fn):
    def broken(*args, **kw):
        out = fn(*args, **kw)
        state = out[0] if isinstance(out, tuple) else out
        state = state.clone()
        state.view(state.shape[0], -1)[:, 0] *= -1  # one spin of every replica
        return (state, *out[1:]) if isinstance(out, tuple) else state
    return broken


@pytest.mark.parametrize("cell", sorted(w["name"] for w in core.benchmark()["workloads"]))
def test_sound_runs_are_correct(here, cell):
    ok, checks = _run(here, cell)
    assert ok and all(v == 0 for _, v, _ in checks)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer_altered"])
def test_torus_faults_are_not_correct(here, monkeypatch, fault):
    from pyisingmontecarlo_tpu_torch.ops import lattice2d

    run = lattice2d.run_steps_2d
    broken = {"unchanged": _unchanged, "half_batch": _half_batch(run), "answer_altered": _one_spin(run)}[fault]
    monkeypatch.setattr(lattice2d, "run_steps_2d", broken)
    ok, checks = _run(here, FERRO)
    assert not ok and any(v > lim for _, v, lim in checks)


def _half_rungs(fn):
    def broken(s, seeds, planes, T, edges):
        x, _ = fn(s, seeds, planes, T, edges)
        h = s.shape[0] // 2
        x = torch.cat([x[:h], s[h:]])
        from pyisingmontecarlo_tpu_torch.ops.ladder import swap_features
        return x, swap_features(x, *edges)
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "answer_altered"])
def test_ladder_faults_are_not_correct(here, monkeypatch, fault):
    from pyisingmontecarlo_tpu_torch.ops import ladder

    run = ladder.ladder_sweeps

    def unchanged(s, seeds, planes, T, edges):
        x = s.clone()
        return x, ladder.swap_features(x, *edges)

    broken = {"unchanged": unchanged, "half_batch": _half_rungs(run), "answer_altered": _one_spin(run)}[fault]
    monkeypatch.setattr(ladder, "ladder_sweeps", broken)
    ok, checks = _run(here, GLASS)
    assert not ok and any(v > lim for _, v, lim in checks)


def test_controls_are_not_correct(tmp_path):
    """The bfloat16 controls at a size a CPU test holds: a 32^2 torus (four
    replicas of 48 sweeps checked) and the tiny ladder."""
    from pb_tiny import TINY_CONFIGS, TINY_PARAMS

    configs = dict(TINY_CONFIGS, sq_ferro_1024={"side": 32})
    params = dict(TINY_PARAMS)
    params[FERRO] = {"timesteps": 48, "num_experiments": 6, "betas": [0.4], "check_replicas": 4}
    here = tiny_copy(tmp_path, configs, params)
    for cell in (FERRO, GLASS):
        checks = controls.control_checks(cell, SEED, "cpu", 8, here=here)
        assert any(v > lim for _, v, lim in checks), (cell, checks)
