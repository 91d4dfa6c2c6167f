"""Entry points: one sweep step of the flagship model, the multi-rank dry run, and a launcher.

Counterpart of ``__graft_entry__.py``. ``entry()`` is one checkerboard sweep
step (four sweeps) of a 256^2 torus with 64 replicas through
``ops/lattice2d.run_steps_2d`` (the ``sq2d_tiled`` kernel on the card).
``dryrun_multichip(n)`` runs the JAX script's stages (a)-(e) on an
``n``-rank world, with each module's ``dryrun_*`` at the same tiny shapes.
``launch`` spawns ``n`` ranks on a ``FileStore`` in a temporary directory
(no TCP port) and returns each rank's result; the rank functions of the tests
live here too, as a rank imports no test module (and so never jax). Every
entry point runs on the card (NCCL, a GPU a rank) unless it is given
``device="cpu"`` (gloo):

    python -m pyisingmontecarlo_tpu_torch.entry --ranks 8 --device cpu
    python -m pyisingmontecarlo_tpu_torch.entry --ranks N
    torchrun --nproc-per-node=N -m pyisingmontecarlo_tpu_torch.entry --torchrun

(the second and third on a machine with N GPUs: every rank runs the dry run.)
"""

from __future__ import annotations

import argparse
import math
import os
import pickle
import queue
import sys
import tempfile
import time
import traceback
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .parallel.mesh import DEFAULT_TIMEOUT, init_distributed, make_mesh

__all__ = ["entry", "dryrun_multichip", "launch", "on_mesh", "drive", "run_all", "mesh_layout"]


def entry(device="cuda"):
    """``(fn, args)``: ``fn(*args)`` runs one checkerboard step (four sweeps at
    beta 0.44, J = -1) on a 256^2 torus with 64 replicas and returns the state."""
    from ._kernels import resolve_device
    from .ops import lattice2d as l2d
    from .rng import replica_seeds_i32

    dev = resolve_device(device)
    L, R = 256, 64
    seeds = torch.from_numpy(replica_seeds_i32(np.arange(R, dtype=np.uint64))).to(dev)
    s = l2d.random_states_2d(seeds, L)
    beta_arr = np.full(4, 0.44, np.float32)
    return l2d.run_steps_2d, (s, seeds, beta_arr, -1.0, 0.0)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """On every rank of a world of at least ``n_devices``: (a) a replica-sharded
    tempering ladder step, (b) a spatially sharded 2D sweep, (c) the same on a
    (replica 2 x space n/2) mesh, (d) a replica-sharded QmcRunner sampling
    step, (e) a (replica 2 x tau n/2) worldline run with its <E> parity
    against one shard; (c) and (e) for even ``n_devices`` only. Returns each
    stage's result (global arrays, the same on every rank)."""
    from .parallel import replica as pr
    from .parallel import spatial as psp
    from .parallel import tau as ptau
    from .parallel import tempering as pt

    n = int(n_devices)
    out = {}
    m1 = make_mesh((n,), ("replica",), device=device)
    out["a"] = pt.dryrun_ladder(m1, replicas_per_device=2, nvars=8, ltau=8, timesteps=2)
    assert np.isfinite(out["a"]).all()
    m2 = make_mesh((n,), ("space",), device=device)
    out["b"] = psp.dryrun_spatial(m2, L=8 * n, replicas=2, sweeps=2)
    if n % 2 == 0:
        m3 = make_mesh((2, n // 2), ("replica", "space"), device=device)
        out["c"] = psp.dryrun_spatial(m3, L=8 * (n // 2), replicas=4, sweeps=1)
    out["d"] = pr.dryrun_runner(m1, replicas_per_device=2, nvars=6, timesteps=2)
    assert np.isfinite(out["d"]).all()
    if n % 2 == 0:
        m5 = make_mesh((2, n // 2), ("replica", "tau"), device=device)
        out["e"] = ptau.dryrun_tau2d(m5, nvars=8, ltau=8 * (n // 2), replicas=32, sweeps=300)
        assert all(np.isfinite(v) for v in (*out["e"][0], *out["e"][1]))
    return out


# ------------------------------------------------------------------ ranks


def on_mesh(shape: Sequence[int], names: Sequence[str], fn: Callable, *args, device="cuda",
            mesh_kw: Optional[str] = None, **kw):
    """Rank function: build the mesh, then ``fn(mesh, *args, **kw)``, or
    ``fn(*args, **kw)`` with the mesh as keyword ``mesh_kw`` when given."""
    mesh = make_mesh(tuple(shape), tuple(names), device=device)
    return fn(*args, **kw, **{mesh_kw: mesh}) if mesh_kw else fn(mesh, *args, **kw)


def drive(obj, shape: Sequence[int], names: Sequence[str], shard: Optional[Callable], shard_kw: dict,
          calls: Sequence, device="cuda"):
    """Rank function: shard ``obj`` with ``shard(obj, mesh, **shard_kw)`` on the
    mesh (no sharding when ``shard`` is None), then make each call ``(method,
    args, kwargs)``; returns their results and ``obj``'s total swaps where it
    counts them."""
    mesh = make_mesh(tuple(shape), tuple(names), device=device)
    if shard is not None:
        shard(obj, mesh, **shard_kw)
    results = [getattr(obj, name)(*args, **kwargs) for name, args, kwargs in calls]
    return results, getattr(obj, "total_swaps", None)


def run_all(jobs: Sequence):
    """Rank function: each job ``(fn, args, kwargs)`` in turn, their results
    in a list; a job that raises ``ValueError`` gives ``("ValueError",
    message)`` in its place (every rank raises it before any collective)."""
    out = []
    for fn, args, kwargs in jobs:
        try:
            out.append(fn(*args, **kwargs))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    return out


def mesh_layout(fn: Callable, *args, **kw):
    """Rank function: the rank grid (nested lists) and dimension names of the
    ``DeviceMesh`` that ``fn(*args, **kw)`` builds (a mesh does not pickle)."""
    mesh = fn(*args, **kw)
    return mesh.mesh.tolist(), mesh.mesh_dim_names


def _rank_main(fn, args, kwargs, rank, n, backend, device, store, timeout, results):
    try:
        torch.set_num_threads(1)
        os.environ["LOCAL_RANK"] = str(rank)
        init_distributed(f"file://{store}", n, rank, backend, device=device, timeout=timeout)
        if "jax" in sys.modules:
            raise RuntimeError("a rank imported jax")
        # plain pickle: the queue's own would share a tensor's storage through
        # this process, which may have exited before the launcher reads it
        results.put((rank, True, pickle.dumps(fn(*args, **kwargs))))
    except BaseException:  # reported to the launcher, which raises
        results.put((rank, False, traceback.format_exc()))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, n: int, backend: Optional[str] = None, device="cuda", timeout: float = DEFAULT_TIMEOUT,
           args: tuple = (), kwargs: Optional[dict] = None) -> list:
    """Run ``fn(*args, **kwargs)`` on ``n`` spawned ranks of one process group
    (``backend`` on ``device``, NCCL for CUDA and gloo for the CPU by default:
    a CUDA rank takes GPU ``rank`` and needs its own) and return their results
    in rank order. ``fn`` and its arguments are
    pickled, so ``fn`` is a module-level function. Raises with the rank's
    traceback when a rank fails, and kills every rank and raises
    ``TimeoutError`` after ``timeout`` seconds."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, args, kwargs or {}, r, n, backend, device, store,
                                                      timeout, results), daemon=True) for r in range(n)]
        for p in procs:
            p.start()
        got, failed, deadline = {}, None, time.monotonic() + timeout
        try:
            while len(got) < n and failed is None:
                try:
                    rank, ok, out = results.get(timeout=0.2)
                except queue.Empty:
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)} did not finish in "
                                           f"{timeout} s") from None
                    dead = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        failed = f"a rank exited with code {dead[0]} without a result"
                    continue
                if ok:
                    got[rank] = pickle.loads(out)
                else:
                    failed = f"rank {rank} failed:\n{out}"
            if failed is not None:
                raise RuntimeError(failed)
            for p in procs:
                p.join(max(1.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
    return [got[r] for r in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=8, help="ranks to spawn for the dry run")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="default: nccl on cuda, gloo on the cpu")
    ap.add_argument("--device", default="cuda", help="cuda (one GPU a rank), or cpu")
    ap.add_argument("--torchrun", action="store_true", help="this process is one rank started by torchrun")
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    if a.torchrun:
        init_distributed(backend=a.backend, device=a.device, timeout=a.timeout)
        out = dryrun_multichip(int(os.environ["WORLD_SIZE"]), device=a.device)
        rank = int(os.environ["RANK"])
    else:
        out, rank = launch(dryrun_multichip, a.ranks, a.backend, a.device, a.timeout, args=(a.ranks,),
                           kwargs=dict(device=a.device))[0], 0
    if rank == 0:
        sharded, one = out.get("e", ((math.nan,) * 2,) * 2)
        print(f"dryrun_multichip: stages {sorted(out)} passed; ladder energies {np.round(out['a'], 4).tolist()}; "
              f"(e) (<E_diag>, kink density): sharded {sharded}, one shard {one}", flush=True)


if __name__ == "__main__":
    main()
