"""Quickstart: temporal k-core queries on a paper-style micro graph.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

import argparse

from repro_torch.core import (PHCIndex, TCQEngine, brute_force_query,
                              iphc_query)
from repro_torch.graphs import paper_style_example


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g = paper_style_example()
    print(f"graph: |V|={g.num_vertices} |E|={g.num_edges} "
          f"pairs={g.num_pairs} span={g.span}")

    eng = TCQEngine(g, device=args.device)

    # the paper's flagship query: ALL distinct 2-cores in any subinterval
    res = eng.query(k=2, Ts=1, Te=8)
    print(f"\nTCQ(k=2, [1,8]) on {eng.device} -> {len(res)} distinct "
          f"temporal 2-cores (evaluated {res.stats.cells_evaluated}/"
          f"{res.stats.cells_total} cells, "
          f"pruned {res.stats.pruned_pct():.0f}%):")
    for c in sorted(res.cores, key=lambda c: c.tti):
        print(f"  TTI=[{c.tti[0]},{c.tti[1]}]  V={sorted(c.vertices.tolist())}"
              f"  |E|={c.n_edges}")

    # sanity: identical to brute force over every subinterval, and the
    # wave engine and the paper's baseline (PHC-Index + Algorithm 1) agree
    oracle = brute_force_query(g, 2, 1, 8)
    wave = eng.query(k=2, Ts=1, Te=8, mode="wave")
    iphc = iphc_query(g, PHCIndex(g, 2, 1, 8, device=args.device), 2, 1, 8)
    for name, r in (("serial", res), ("wave", wave), ("iPHC", iphc)):
        assert set(c.tti for c in r.cores) == set(oracle.keys()), name
        for c in r.cores:
            assert set(c.vertices.tolist()) == oracle[c.tti]["vertices"], name
            assert c.n_edges == oracle[c.tti]["n_edges"], name
    print("\nserial, wave and iPHC match the brute-force oracle ✓")

    # §6.2 extensions: link strength and time-span constraints
    strong = eng.query(k=2, Ts=1, Te=8, h=2)
    short = eng.query(k=2, Ts=1, Te=8, max_span=2)
    print(f"link-strength h=2 -> {len(strong)} cores;"
          f" span<=2 -> {len(short)} cores "
          f"{sorted(c.tti for c in short.cores)}")

    # historical k-core (the paper's Def. 1 special case) = top core
    top = max(res.cores, key=lambda c: c.n_edges)
    print(f"historical 2-core of [1,8] = core with TTI {top.tti}, "
          f"|V|={top.n_vertices}")


if __name__ == "__main__":
    main()
