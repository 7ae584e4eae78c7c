"""Worlds of worker processes: one process per rank, each running the same
function under ``torch.distributed``.

    results = run_world("package.module:function", 4, args=(...),
                        backend="gloo", timeout_s=120)

Each rank is a fresh interpreter (``python -m repro_torch.launch.world``,
so a parent that has already initialised CUDA or imported JAX can start
worlds safely).  The ranks meet through a ``file://`` rendezvous in a
private directory, never a fixed TCP port, so concurrent worlds (test
workers) cannot collide.  ``function(*args)`` runs on every rank after
the process group is up; its return values come back in rank order.  A
rank that fails, or a world that outlives ``timeout_s``, kills every rank
and raises with the tail of each rank's log.
"""

from __future__ import annotations

import importlib
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

_SRC = str(Path(__file__).resolve().parents[2])


def run_world(target: str, world_size: int, *, args=(),
              backend: str = "gloo", timeout_s: float = 300.0) -> list:
    """Run ``target`` ("module:function") on ``world_size`` ranks; return
    each rank's result, rank 0 first."""
    work = Path(tempfile.mkdtemp(prefix="tcq_world_"))
    try:
        with open(work / "spec.pkl", "wb") as f:
            pickle.dump({"target": target, "args": tuple(args),
                         "backend": backend,
                         "timeout_s": float(timeout_s)}, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_SRC] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p])
        env["OMP_NUM_THREADS"] = "1"     # ranks share the host's cores
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                    "MASTER_PORT"):
            env.pop(var, None)
        procs, logs = [], []
        for r in range(int(world_size)):
            log = open(work / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.world",
                 str(work), str(r), str(int(world_size))],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + float(timeout_s)
        timed_out = False
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    timed_out = True
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for log in logs:
                log.close()
        rcs = [p.returncode for p in procs]
        if any(rcs):
            tails = "\n".join(
                f"--- rank {r} (exit {rc}):\n"
                + (work / f"rank{r}.log").read_text()[-3000:]
                for r, rc in enumerate(rcs))
            why = (f"timed out after {timeout_s:.0f} s" if timed_out
                   else "failed")
            raise RuntimeError(f"world of {world_size} ranks running "
                               f"{target} {why}:\n{tails}")
        out = []
        for r in range(int(world_size)):
            with open(work / f"out{r}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _rank_main(work: str, rank: int, world_size: int) -> None:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_world

    work = Path(work)
    with open(work / "spec.pkl", "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)
    init_world(spec["backend"], init_method=f"file://{work}/rendezvous",
               rank=rank, world_size=world_size,
               timeout_s=spec["timeout_s"])
    try:
        mod, fn = spec["target"].split(":")
        result = getattr(importlib.import_module(mod), fn)(*spec["args"])
        with open(work / f"out{rank}.tmp", "wb") as f:
            pickle.dump(result, f)
        os.replace(work / f"out{rank}.tmp", work / f"out{rank}.pkl")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
