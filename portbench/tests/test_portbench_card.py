"""On the card: every cell through ``run.py`` (a short window, untraced and
traced) comes out correct with its metrics, and every control at its cell's
own size comes out not correct. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import controls, core

BENCH = core.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(card, cell, trace):
    proc = subprocess.run([sys.executable, str(core.HERE / "run.py"), "--workload", cell, "--seed", str(2**31 + 5),
                           "--seconds", "3", "--trace", str(trace)], cwd=core.REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1
    if trace:
        assert res["device"]["busy_s"] > 0 and set(res["metrics"]) == {
            m["name"] for m in core.per_layer_metrics(BENCH, cell)}
        assert res["breakdown"]["device_ops"]
    else:
        assert {"setup_s"} < set(res["metrics"])
    assert list(res)[-1] == "checks"


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_not_correct_at_cell_size(card, cell):
    checks = controls.control_checks(cell, 2**31 + 9, "cuda", 20)
    assert any(v > lim for _, v, lim in checks), checks
