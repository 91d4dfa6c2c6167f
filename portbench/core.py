"""The harness: finds a cell's files by name, runs its closed loop for a
window, reads the trace in a traced run, judges the window's outputs against
the plain reference, and writes the result line.

Everything that belongs to one configuration, cell, entry point or
per-layer metric sits in a file of its own, found by name:

- ``configs/<config>.json``: the configuration as it is run;
- ``workloads/<cell>.json``: ``config``, ``traffic``, ``driver``, ``chips``,
  ``params`` (the traffic's parameters), ``trace_calls`` (the calls a traced
  window holds);
- ``drivers/<driver>.py``: a ``Driver`` class that builds the program's
  object from the configuration, the parameters and the seed, warms it up,
  makes one timed call, reads the program's counters and judges the outputs
  kept from the window against ``reference/``;
- ``metrics/<metric>.py``: ``read(view)``, a per-layer metric from a traced
  window (``tracing.TraceView``), or None when there is nothing to read.

``BENCHMARK.json`` at the root names the cells and the metrics, with their
units and the cells each metric is read in. An end-to-end rate's unit
``<work>/<time>`` names the work count of the drivers' calls that it sums
(``rate_of``).
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from pathlib import Path

__all__ = ["HERE", "REPO", "FORBIDDEN", "load_json", "benchmark", "workload", "config", "load_module",
           "forbidden_modules", "TIME_UNITS", "rate_of", "rates", "per_layer_metrics", "Cell", "run_cell",
           "format_checks"]

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
# top-level module names that may not be loaded in a run: the JAX stack and the JAX package (the port's
# own name, pyisingmontecarlo_tpu_torch, is another top-level name)
FORBIDDEN = ("jax", "jaxlib", "flax", "pyisingmontecarlo_tpu")
TIME_UNITS = {"s": 1.0, "ms": 1e-3, "us": 1e-6, "ns": 1e-9}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = REPO) -> dict:
    return load_json(root / "BENCHMARK.json")


def workload(name: str, here: Path = HERE) -> dict:
    return load_json(here / "workloads" / f"{name}.json")


def config(name: str, here: Path = HERE) -> dict:
    return load_json(here / "configs" / f"{name}.json")


def load_module(kind: str, name: str, here: Path = HERE):
    """The module ``<here>/<kind>/<name>.py`` (a name may hold dots)."""
    path = here / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name, compared whole, is in ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def rate_of(unit: str):
    """``(work, seconds)`` of a rate's unit ``<work>/<time>``: the key of the
    drivers' work counts that it sums, and the seconds of its time unit."""
    work, _, per = unit.partition("/")
    return work, TIME_UNITS[per]


def rates(bench: dict, cell: str) -> list:
    """The end-to-end rates a cell reports: every end-to-end metric but
    ``setup_s`` that lists the cell, or lists no cells."""
    return [m for m in bench["end_to_end"] if m["name"] != "setup_s" and cell in m.get("workloads", [cell])]


def per_layer_metrics(bench: dict, cell: str) -> list:
    """The per-layer metrics that list the cell."""
    return [m for m in bench["per_layer"] if cell in m["workloads"]]


class Cell:
    """A cell's files, read by name from ``here`` (``portbench/``) and the
    benchmark file at ``root``."""

    def __init__(self, name: str, here: Path = HERE, root: Path = REPO):
        self.name, self.here = name, here
        self.bench = benchmark(root)
        entry = next((w for w in self.bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json")
        self.spec = workload(name, here)
        for key in ("config", "traffic", "chips"):
            if self.spec[key] != entry[key]:
                raise ValueError(f"workloads/{name}.json has {key}={self.spec[key]!r}, BENCHMARK.json {entry[key]!r}")
        self.config = config(self.spec["config"], here)
        self.units = {m["name"]: m["unit"] for m in self.bench["end_to_end"] + self.bench["per_layer"]}
        self.rates = rates(self.bench, name)
        self.per_layer = per_layer_metrics(self.bench, name)

    def driver(self, seed: int, device: str):
        return load_module("drivers", self.spec["driver"], self.here).Driver(self.config, self.spec["params"],
                                                                             int(seed), device)


def _window(driver, seconds: float):
    """Back-to-back calls while the window is open: ``(calls, failed, work,
    seconds)``; the window ends when the last call that started inside it
    ends. A call that raises ends the window and counts as failed."""
    calls = failed = 0
    work: dict = {}
    took = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t_call = time.perf_counter()
        try:
            done = driver.call()
        except Exception as e:  # the program's failure is the run's result: counted and reported
            print(f"call {calls} failed: {type(e).__name__}: {e}", file=sys.stderr)
            failed += 1
            calls += 1
            break
        calls += 1
        took.append(time.perf_counter() - t_call)
        for k, v in done.items():
            work[k] = work.get(k, 0) + v
    window_s = time.perf_counter() - t0
    if took:
        print(f"window: {calls} calls in {window_s:.3f} s; a call {min(took):.4f} s least, "
              f"{sorted(took)[len(took) // 2]:.4f} median, {max(took):.4f} most, the first {took[0]:.4f}",
              file=sys.stderr)
    return calls, failed, work, window_s


def format_checks(checks) -> dict:
    return {name: {"value": value, "limit": limit} for name, value, limit in checks}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str, t_start: float,
             here: Path = HERE, root: Path = REPO, device_info=None):
    """One run of a cell: ``(result, checks, found)``: the line's object
    without its checks, ``[(name, value, limit)]``, and the forbidden modules
    loaded once the window had closed. ``t_start`` is the process's start on
    the host clock; ``device_info()`` reads ``device`` once the window has
    closed."""
    from . import tracing

    cell = Cell(name, here, root)
    t_built = time.perf_counter()
    driver = cell.driver(seed, device)
    t_warm = time.perf_counter()
    driver.warm()
    setup_s = time.perf_counter() - t_start
    print(f"set-up: {t_built - t_start:.3f} s to the cell's files, {t_warm - t_built:.3f} s the inputs and the "
          f"program's object, {setup_s - (t_warm - t_start):.3f} s the warm-up", file=sys.stderr)
    breakdown = None
    if trace:
        view = tracing.trace_window(driver, int(cell.spec.get("trace_calls", 1)))
        calls, failed = view.attempted, view.failed
        metrics = {}
        for m in cell.per_layer:
            v = load_module("metrics", m["name"], here).read(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = view.breakdown()
    else:
        calls, failed, work, window_s = _window(driver, seconds)
        metrics = {}
        for m in cell.rates:
            if failed == 0 and window_s > 0:
                key, unit_s = rate_of(m["unit"])
                metrics[m["name"]] = {"value": work.get(key, 0) / (window_s / unit_s), "unit": m["unit"]}
        metrics["setup_s"] = {"value": setup_s, "unit": cell.units["setup_s"]}
    dev = device_info() if device_info else {"platform": device, "count": 1}
    if trace:
        dev.update(busy_s=view.busy_s, window_s=view.window_s)
    found = forbidden_modules()
    driver.release()
    t_check = time.perf_counter()
    checks = driver.check()
    print(f"set-up {setup_s:.3f} s, {calls} calls, reference check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    correct = failed == 0 and not found and all(v <= lim for _, v, lim in checks)
    result = {"correct": bool(correct), "attempted": calls, "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    return result, checks, found
