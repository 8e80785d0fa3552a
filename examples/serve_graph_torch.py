"""Resident graph serving on the PyTorch port: a ProgramServer answering a
multi-tenant stream of BFS/SSSP queries over resident graphs, on a
virtual fabric of 8 shards (counterpart of ``examples/serve_graph.py``).

1. register resident graphs and pre-warm every (program, graph, width)
   shape class;
2. serve a mixed-tenant stream: many roots fused into tenant-column
   batches, one launch a batch, no rebuild;
3. admission control: an undersized per-tenant budget gets a retriable
   rejection, not a silent drop, and succeeds on retry once the
   tenant's queued work drains;
4. print the per-tenant / aggregate serving stats snapshot.

  PYTHONPATH=src python examples/serve_graph_torch.py [--requests 24]
      [--device cpu]
"""
import argparse
import json

import numpy as np

from repro_torch.core.fabric import Fabric
from repro_torch.core.queues import QueueConfig
from repro_torch.serve import STATUS_OK, ProgramServer, Request
from repro_torch.sparse import datasets


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--width", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    fabric = Fabric.fake(8, device=args.device)
    graphs = {"wiki": datasets.wiki_like(256, avg_degree=6, seed=3),
              "road": datasets.erdos_renyi(256, avg_degree=4, seed=7)}
    server = ProgramServer(fabric, graphs, batch_width=args.width)

    print(f"== pre-warm on {fabric.n_devices} shards of {fabric.device} ==")
    for (prog, gname), keys in server.prewarm(("bfs", "sssp")).items():
        print(f"  {prog}/{gname}: {len(keys)} round-function key(s)")

    print(f"== serving {args.requests} mixed-tenant requests ==")
    rng = np.random.default_rng(0)
    tenants = ["acme", "globex", "initech", "umbrella"]
    stream = [Request(req_id=i, tenant=tenants[(i // 4) % len(tenants)],
                      program=("bfs", "sssp")[i % 2],
                      graph=("wiki", "road")[(i // 2) % 2],
                      root=int(rng.integers(256)))
              for i in range(args.requests)]
    responses = server.run(stream)
    ok = sum(r.status == STATUS_OK for r in responses)
    print(f"  {ok}/{len(responses)} ok; "
          f"{server.stats.launches} fused launches; "
          f"cache hit rate {server.stats.cache_hit_rate:.2f}")
    if ok != len(responses):
        raise SystemExit("a request of the stream failed")

    print("== admission control (undersized budget) ==")
    # budget = cap x n_dev: one wiki query's worst-case per-round demand
    # (its edge count), not two
    one_req = QueueConfig.from_cap(graphs["wiki"].nnz // 8 + 1, "serve")
    tiny = ProgramServer(fabric, graphs, batch_width=args.width,
                         default_queues=one_req)
    first = tiny.submit(Request(req_id=0, tenant="acme", program="bfs",
                                graph="wiki", root=1))
    print(f"  submit #1 -> {'admitted' if first is None else first.status}")
    second = tiny.submit(Request(req_id=1, tenant="acme", program="bfs",
                                 graph="wiki", root=2))
    print(f"  submit #2 -> {second.status} (retriable={second.retriable}): "
          f"{second.reason}")
    tiny.drain()
    retry = tiny.submit(Request(req_id=1, tenant="acme", program="bfs",
                                graph="wiki", root=2))
    print(f"  retry after drain -> "
          f"{'admitted' if retry is None else retry.status}")
    tiny.drain()
    if first is not None or second is None or not second.retriable \
            or retry is not None:
        raise SystemExit("admission control did not reject and re-admit")

    server.stats.verify()
    print("== stats snapshot ==")
    print(json.dumps(server.stats.snapshot(), indent=2, default=float))


if __name__ == "__main__":
    main()
