"""End-to-end TCQ serving driver: batched time-range k-core queries over a
live (dynamically growing) temporal graph — the paper's system as a service.

  * requests arrive as (k, [Ts, Te]) windows (TCQRequestStream);
  * each batch is served through ``TCQEngine.query_batch``: one shared
    lane pool packs schedule cells from every in-flight request into the
    same wave steps (per-lane k/h/window), so lanes freed by one query's
    draining tail are refilled by another's — the reported occupancy is
    the mean cells per device step;
  * every answer is held to the same request run alone in serial mode
    (the paper-faithful schedule) on the same snapshot;
  * between batches, new edges arrive (EdgeStream) and the engine takes
    the new epoch in place — the paper's §6.1 dynamic-graph scenario.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_tcq
      [--requests 12] [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch.core import TCQEngine
from repro_torch.data import TCQRequestStream
from repro_torch.graphs import EdgeStream, powerlaw_temporal


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = powerlaw_temporal(1200, 12_000, 16_384, seed=1)
    future = powerlaw_temporal(1200, 3_000, 4_096, seed=2)

    stream = EdgeStream(base)
    arrivals = EdgeStream.replay(future, 3)
    lo, hi = base.span
    reqs = list(TCQRequestStream(lo, hi, k=args.k, span=400,
                                 seed=0).requests(args.requests))

    eng = TCQEngine(stream.graph, device=args.device)
    lat = []
    for i in range(0, len(reqs), args.batch):
        batch = reqs[i:i + args.batch]
        t0 = time.perf_counter()
        # one shared lane pool serves the whole batch (mixed k/h/windows)
        results = eng.query_batch(batch)
        dt = time.perf_counter() - t0
        lat.append(dt / len(batch))
        for r, res in zip(batch, results):
            alone = eng.query(r["k"], r["ts"], r["te"], h=r.get("h", 1))
            assert res.by_tti().keys() == alone.by_tti().keys(), r["id"]
            print(f"req#{r['id']:03d} k={r['k']} window=[{r['ts']},{r['te']}]"
                  f" -> {len(res)} cores "
                  f"{[c.tti for c in res.top_n_shortest_span(3)]}")
        # pool counters are batch-wide, but empty-window requests never
        # enter the pool — report from a member that did device work
        s = next((r.stats for r in results if r.stats.device_steps), None)
        if s is not None:
            print(f"  [pool] {s.device_steps} steps, "
                  f"occupancy {s.occupancy:.1f} cells/step")
        # dynamic arrival between batches (paper §6.1): incremental
        # merge-append + in-place engine epoch swap — no rebuild
        try:
            u, v, t = next(arrivals)
            t = t + hi  # future timestamps
            g2 = stream.push(u, v, t)
            eng.update_graph(g2)
            print(f"  [stream] +{len(u)} edges -> |E|={g2.num_edges} "
                  f"(epoch {eng.epoch})")
        except StopIteration:
            pass
    print(f"\nserved {len(reqs)} requests on {eng.device}, each equal to "
          f"its serial run; mean latency {1e3 * np.mean(lat):.1f} ms/req, "
          f"p95 {1e3 * np.quantile(lat, 0.95):.1f} ms/req")


if __name__ == "__main__":
    main()
