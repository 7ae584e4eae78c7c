"""Dynamic temporal graph (paper §6.1 + §7.4 case-study flavor): stream
edge batches into the TEL and watch a community grow across re-queries —
the bursting-community analysis of the paper's Fig. 15 — on the streaming
service runtime: each arrival batch is an *incremental* merge-append
producing a new epoch (no engine rebuild, no full re-sort), and queries
submitted after a push see the new edges.  Every answer is held to the
brute-force oracle on the ticket's snapshot.

Run:  PYTHONPATH=src python -m repro_torch.examples.dynamic_graph
      [--device cpu]
"""

import argparse

from repro_torch.core import TCQService, brute_force_query
from repro_torch.graphs import EdgeStream, planted_cores


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g = planted_cores(num_vertices=80, k=3, n_cliques=5, clique_size=7,
                      time_span=60, noise_edges=150, seed=13)
    stream = EdgeStream()
    print("streaming the graph in 5 arrival batches; querying after each\n")
    svc = None
    prev_ttis = set()
    for i, (u, v, t) in enumerate(EdgeStream.replay(g, 5)):
        cur = stream.push(u, v, t)
        if svc is None:
            # first batch bootstraps the service; later epochs arrive via
            # the stream subscription (incremental merge-append, O(E+B))
            svc = TCQService(cur, device=args.device)
            svc.connect(stream)
        tk = svc.submit({"k": 3, "ts": 1, "te": 60})
        svc.run_until_idle()
        res = tk.result
        oracle = brute_force_query(cur, 3, 1, 60)
        assert res.by_tti().keys() == oracle.keys(), f"batch {i + 1}"
        new = set(c.tti for c in res.cores) - prev_ttis
        prev_ttis |= new
        print(f"batch {i+1}: epoch={tk.epoch} |E|={cur.num_edges:5d} -> "
              f"{len(res):3d} cores ({len(new)} new), equal to the oracle")
        # growth analysis: nested cores = community expansion (Fig. 15)
        chains = 0
        for c in res.cores:
            for c2 in res.cores:
                if (c2.tti[0] <= c.tti[0] and c.tti[1] <= c2.tti[1]
                        and c.n_vertices < c2.n_vertices
                        and set(c.vertices).issubset(set(c2.vertices))):
                    chains += 1
                    break
        print(f"          {chains} cores are nested inside a larger, "
              f"longer-lived core (growth chains)")
    top = sorted(res.cores, key=lambda c: -c.n_vertices)[:3]
    print("\nlargest communities at the end:")
    for c in top:
        print(f"  {c}")
    occ = [p["occupancy"] for p in svc.pool_log if p["device_steps"]]
    print(f"\nserved {len(svc.completed)} queries over {svc.epoch + 1} "
          f"epochs on {svc.engine.device}, {len(svc.pool_log)} pools, "
          f"mean occupancy {sum(occ) / max(1, len(occ)):.1f} cells/step")


if __name__ == "__main__":
    main()
