"""Run cells of the benchmark several times, one process a run, and summarise.

    python3 portbench/series.py --out DIR CELL:SEEDS[:TRACE] ... [--seconds S]

``SEEDS`` is a comma-separated list; each run is ``run.py --workload CELL
--seed SEED --seconds S --trace TRACE`` (S defaults to ``run_seconds`` of
``BENCHMARK.json``). Every run's result line and the end of its standard
error go to ``DIR/<cell>.jsonl``; the summary gives each metric's median
and its spread (the distance between the first and third quartiles of
``statistics.quantiles(values, n=4)`` over the median).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", required=True)
    p.add_argument("--seconds", type=float)
    p.add_argument("runs", nargs="+", help="CELL:SEED,SEED,...[:TRACE]")
    args = p.parse_args(argv)
    seconds = args.seconds or json.loads((REPO / "BENCHMARK.json").read_text())["run_seconds"]
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    status = 0
    for spec in args.runs:
        cell, seeds, *rest = spec.split(":")
        trace = int(rest[0]) if rest else 0
        values, n_ok = {}, 0
        for seed in seeds.split(","):
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", cell, "--seed", seed,
                                   "--seconds", str(seconds), "--trace", str(trace)],
                                  cwd=REPO, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
            try:
                res = json.loads(line)
            except json.JSONDecodeError:
                res = None
            rec = {"cell": cell, "seed": int(seed), "trace": trace, "rc": proc.returncode, "wall_s": wall,
                   "result": res, "stderr": proc.stderr[-3000:]}
            with open(out / f"{cell}.jsonl", "a") as f:
                f.write(json.dumps(rec) + "\n")
            ok = proc.returncode == 0 and res is not None and res.get("correct")
            n_ok += bool(ok)
            if not ok:
                status = 1
            brief = {} if res is None else {k: v["value"] for k, v in res["metrics"].items()}
            print(f"{cell} seed {seed} trace {trace}: rc {proc.returncode}, correct "
                  f"{None if res is None else res['correct']}, wall {wall:.1f} s, {brief}", flush=True)
            if not ok:
                print(proc.stderr[-1500:], flush=True)
            for k, v in brief.items():
                values.setdefault(k, []).append(v)
        for k, v in values.items():
            s = spread(v)
            print(f"{cell} {k}: median {statistics.median(v)!r}, spread {s!r} over {len(v)} runs; {v}", flush=True)
        print(f"{cell}: {n_ok} of {len(seeds.split(','))} runs correct", flush=True)
    return status


if __name__ == "__main__":
    sys.exit(main())
