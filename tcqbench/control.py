#!/usr/bin/env python3
"""The control of ``correct``: the reference put in the program's place with
one guarantee broken, which the comparison has to fail.

The configurations state exact answers.  The control peels each cell for
at most ``--max-iters`` rounds, short of its fixpoint: the shortcut that
would tempt a later change (the port's composite peel has a
``max_iters``).  For each seed it draws as many queries as a run of the
cell checks, from the cell's first batches, has the control answer them
and counts the cores that differ from the reference's.  Sound runs read
0, so the control must read more.

    python3 tcqbench/control.py --workload tcq-youtube.batch \
        --seeds 11,12,13 [--max-iters 2] [--device cuda]

It imports nothing of the program, and the benchmark's runs never run it.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def checked_queries(workload: dict, seed: int, t_min: int, t_max: int):
    """The first ``check_queries`` requests of the cell's batches."""
    from tcqbench import gen

    p = workload["params"]
    n = int(p["check_queries"])
    reqs, b = [], 0
    while len(reqs) < n:
        reqs += gen.batch_requests(p["requests"], seed, b, t_min, t_max)
        b += 1
    return reqs[:n]


def control_numbers(workload: dict, config: dict, seed: int, device: str,
                    max_iters: int = 2, edges=None) -> dict:
    from tcqbench import cell
    from tcqbench.check import differing
    from tcqbench.reference.otcd import EdgeList, otcd

    u, v, t = cell.edges(config) if edges is None else edges
    el = EdgeList(u, v, t, device=device)
    bad = checked = 0
    kept = t[u != v]        # the program's graph drops self-loops
    for r in checked_queries(workload, seed, int(kept.min()),
                             int(kept.max())):
        want = otcd(el, r["k"], r["ts"], r["te"], h=r["h"])
        got = otcd(el, r["k"], r["ts"], r["te"], h=r["h"],
                   max_iters=max_iters)
        bad += differing(got, want)
        checked += 1
    return {"cores_differing": bad, "queries_checked": checked}


def main() -> int:
    from tcqbench.run import load_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--max-iters", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    _, _, workload, config = load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_numbers(workload, config, seed, args.device,
                              args.max_iters)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "max_iters": args.max_iters, **out,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
