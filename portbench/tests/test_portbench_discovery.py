"""A cell, a configuration and a per-layer metric added as new files are
found by name, with no file that exists edited."""

import hashlib
import json
import time

from pb_tiny import tiny_copy

from portbench import core


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_cell_config_and_metric_found_by_name(tmp_path):
    here = tiny_copy(tmp_path)
    before = _digests(here)
    (here / "configs" / "sq_ferro_12.json").write_text(json.dumps(
        {"source": "https://example.org/ferro12", "side": 12, "j": -1.0, "h": 0.0, "reduced": []}))
    (here / "workloads" / "ferro12.r3.json").write_text(json.dumps(
        {"config": "sq_ferro_12", "traffic": "r3", "driver": "run_monte_carlo", "chips": 1,
         "params": {"timesteps": 6, "num_experiments": 3, "betas": [0.5], "check_replicas": 2}, "trace_calls": 2}))
    (here / "metrics" / "calls_traced.r3.py").write_text('"""Traced calls."""\n\n\ndef read(view):\n'
                                                          '    return view.calls\n')
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "sq_ferro_12", "source": "https://example.org/ferro12",
                             "file": "portbench/configs/sq_ferro_12.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "ferro12.r3", "config": "sq_ferro_12", "traffic": "r3", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "spin_updates_per_ns":
            m["workloads"].append("ferro12.r3")
    bench["per_layer"].append({"name": "calls_traced.r3", "unit": "calls", "better": "higher", "source": "program_counter",
                               "layer": "device", "moves": "spin_updates_per_ns", "workloads": ["ferro12.r3"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    res, checks, found = core.run_cell("ferro12.r3", 2**33 + 1, 0.2, False, "cpu", time.perf_counter(),
                                          here=here, root=tmp_path)
    assert res["correct"] and res["attempted"] >= 1 and not found
    assert set(res["metrics"]) == {"spin_updates_per_ns", "setup_s"}
    res, _, _ = core.run_cell("ferro12.r3", 2**33 + 1, 0.2, True, "cpu", time.perf_counter(), here=here,
                                 root=tmp_path)
    assert res["correct"] and res["metrics"]["calls_traced.r3"]["value"] == 2
    after = _digests(here)
    assert all(after[p] == d for p, d in before.items()), "a file that existed was edited"
