"""Quickstart on the PyTorch port: the DCRA framework in five acts
(counterpart of ``examples/quickstart.py``).

  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Acts 1-2 are the analytic model (numpy); act 3 runs the histogram
kernel on the card (its plain PyTorch version on a CPU tensor); acts
4-5 a reduced Mixtral on the device.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.fabric import resolve_device
from repro_torch.core.task_engine import EngineConfig, TaskEngine
from repro_torch.core.topology import TileGrid
from repro_torch.costmodel import run_energy, run_perf
from repro_torch.kernels import histogram as histogram_kernel
from repro_torch.kernels.ops import histogram
from repro_torch.models.model_zoo import build_model
from repro_torch.sparse import apps, datasets, ref


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    dev = resolve_device(ap.parse_args(argv).device)

    # -- 1. a graph + the DCRA task engine (the paper's execution model) --
    g = datasets.rmat(10, edge_factor=8)
    grid = TileGrid(8, 8, topology="hier_torus", die_rows=4, die_cols=4)
    engine = TaskEngine(EngineConfig(grid=grid), g.n)
    dist, stats = apps.bfs(engine, g, root=0)
    assert np.array_equal(dist, ref.bfs_ref(g, 0))
    print(f"BFS on RMAT-10: {stats.total_messages} task messages, "
          f"{stats.total_hops} NoC hops over a {grid.topology} grid")

    # -- 2. performance / energy / cost from the paper's models ----------
    perf = run_perf(stats, engine.cfg, g.nnz, dataset_bytes=g.memory_bytes())
    en = run_energy(stats, engine.cfg, dataset_bytes=g.memory_bytes())
    print(f"model: {perf.teps:.2e} TEPS, {en.total_j * 1e6:.1f} uJ "
          f"(NoC {en.noc_j / en.total_j:.0%}, mem "
          f"{en.memory_j / en.total_j:.0%}, PU {en.pu_j / en.total_j:.0%})")

    # -- 3. the histogram kernel (CUDA on the card) -----------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    els = torch.randint(0, 256, (4096,), generator=gen, device=dev,
                        dtype=torch.int32)
    before = histogram_kernel.LAUNCHES["histogram"]
    ok = bool(torch.equal(histogram(els, 256).long(),
                          torch.bincount(els.long(), minlength=256)))
    launched = histogram_kernel.LAUNCHES["histogram"] - before
    print(f"histogram kernel ok: {ok} ({launched} kernel launch on {dev})")
    assert ok and launched == (dev.type == "cuda")

    # -- 4. an assigned architecture, reduced: its loss ------------------
    cfg = get_config("mixtral-8x22b").reduced()
    model = build_model(cfg, device=dev).init(gen)
    tok = torch.randint(0, cfg.vocab_size, (2, 64), generator=gen,
                        device=dev)
    with torch.no_grad():
        loss, metrics = model.loss({"tokens": tok, "labels": tok})
    print(f"mixtral-8x22b (reduced) loss: {float(loss):.3f} "
          f"(aux {float(metrics['aux']):.3f})")

    # -- 5. one greedy decode step with a KV cache ------------------------
    with torch.no_grad():
        cache = model.init_cache(2, 64, torch.float32)
        logits, cache = model.decode_step(cache, tok[:, :1], 0)
    print("decode step ok:", tuple(logits.shape))


if __name__ == "__main__":
    main()
