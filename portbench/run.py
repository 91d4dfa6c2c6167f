"""Run one cell of the port's benchmark once, on the card, and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (the kernels loaded from the port's
build cache inside the checkout, built there on a first run; the inputs
made from the seed; a warm-up on the cell's own shapes) counts as
``setup_s``; then back-to-back calls for ``--seconds`` (``--trace 0``: the
cell's end-to-end metrics) or a traced window (``--trace 1``: its per-layer
metrics). Then the outputs kept from the window are judged against the plain
reference. The last lines of standard error, and the result line's last key
``checks``, give each number compared with its limit; the last line of
standard output is the result.

Exits non-zero, with no result, without CUDA or with fewer cards than the
cell asks for, or when the JAX stack or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
# caches a library might write: fixed directories inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(REPO / ".portbench_cache" / sub)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import core

    t_torch = time.perf_counter() - T_START
    chips = core.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"the cell asks for {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)  # the host's load: one process, few threads
    torch.zeros(1, device="cuda")
    print(f"set-up: torch imported at {t_torch:.3f} s, the card's context made at {time.perf_counter() - T_START:.3f} s",
          file=sys.stderr)

    def device_info():
        torch.cuda.synchronize()
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}

    result, checks, found = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
                                             T_START, device_info=device_info)
    found = sorted(set(found) | set(core.forbidden_modules()))
    if found:
        print(f"modules that may not be loaded were loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} {value} limit {limit}", file=sys.stderr)
    result["checks"] = core.format_checks(checks)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
