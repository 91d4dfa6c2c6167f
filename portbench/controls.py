"""The controls of the check that decides ``correct``: the plain reference in
the program's place, computed in the precision below the one the
configuration states, judged by the cell's own check at the cell's own size.

    python3 portbench/controls.py --workload CELL --seeds A,B,C [--calls N] [--out FILE]

Every control has to come out as not correct: at least one number compared
above its limit. The f32 thresholds of the square torus become bfloat16
ones; the tempering ladder's f32 sweep and swap step run in bfloat16.
``--calls`` is the window's calls that the torus cells' check chooses from.
Prints each number with its limit, a line a seed.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def control_checks(cell: str, seed: int, device: str, calls: int, here=None):
    """``[(name, value, limit)]`` of the control of ``cell`` on ``seed``."""
    import torch

    from portbench import core

    kw = {} if here is None else {"here": here}
    spec = core.workload(cell, **kw)
    judge = core.load_module("drivers", spec["driver"], **kw).Judge(core.config(spec["config"], **kw), spec["params"],
                                                                    seed, device)
    if hasattr(judge, "kept"):
        judge.control(torch.bfloat16, calls)
    else:
        judge.control(torch.bfloat16)
    return judge.check()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--calls", type=int, default=20)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("controls run on the card", file=sys.stderr)
        return 2
    failed_all = True
    for seed in args.seeds.split(","):
        t0 = time.perf_counter()
        checks = control_checks(args.workload, int(seed), "cuda", args.calls)
        fails = any(v > lim for _, v, lim in checks)
        failed_all &= fails
        rec = {"cell": args.workload, "seed": int(seed), "control": "bfloat16", "seconds": time.perf_counter() - t0,
               "not_correct": fails, "checks": {n: {"value": v, "limit": lim} for n, v, lim in checks}}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
