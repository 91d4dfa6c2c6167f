"""A copy of the benchmark's files with the cells cut to sizes a CPU test run holds."""

import json
import shutil
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
REPO = HERE.parent

TINY_CONFIGS = {"sq_ferro_1024": {"side": 16}, "pmj_glass_80_pt64": {"side": 4, "rungs": 8}}
TINY_PARAMS = {
    "ferro1024.r100": {"timesteps": 8, "num_experiments": 5, "betas": [0.4], "check_replicas": 2},
    "ferro1024.r8": {"timesteps": 12, "num_experiments": 2, "betas": [0.4], "check_replicas": 2},
    "ferro1024.scan": {"timesteps": 6, "num_experiments": 5, "betas": [0.3, 0.5], "check_replicas": 2},
    "glass80.pt": {"timesteps": 5, "replica_swap_freq": 1, "warm_timesteps": 3, "check_sweeps": 2},
}


def edit(path: Path, **kw) -> None:
    d = json.loads(path.read_text())
    d.update(kw)
    path.write_text(json.dumps(d))


def tiny_copy(tmp: Path, configs=TINY_CONFIGS, params=TINY_PARAMS) -> Path:
    """``tmp`` holding ``BENCHMARK.json`` and ``portbench/`` with tiny cells;
    returns the copy's ``portbench``."""
    here = tmp / "portbench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for name, kw in configs.items():
        edit(here / "configs" / f"{name}.json", **kw)
    for name, p in params.items():
        edit(here / "workloads" / f"{name}.json", params=p)
    return here
