"""Each plain reference against the port at a tiny size on the CPU, and
each control (the reference in the port's place, a precision lower or
its guarantee broken) found wrong by the same check."""
import numpy as np
import pytest
import torch

from dcra_bench import control
from dcra_bench.drivers import moe_layer
from dcra_bench.gen import kron, moe_inputs
from dcra_bench.reference import graph as ref_graph
from dcra_bench.reference import moe as ref_moe


@pytest.fixture(scope="module")
def small_graph():
    from repro_torch.sparse.csr import CSR
    g = kron.kron(10, 16, (0.57, 0.19, 0.19), 2 ** 31 + 9, "cpu")
    rp, ci, vals = g.host()
    return g, CSR(rp, ci, vals)


def _launch(prog, csr, params):
    from repro_torch.core.fabric import Fabric
    from repro_torch.sparse.options import LaunchOptions
    from repro_torch.sparse.program import launch_program
    return launch_program(prog, csr, Fabric.fake(8, device="cpu"),
                          options=LaunchOptions(capacity_factor=4.0),
                          params=params).result()


def test_bfs_reference_matches_the_port(small_graph):
    from repro_torch.sparse.torch_apps import BFS
    g, csr = small_graph
    rows, cols = g.rows(), g.col_idx.long()
    for root in kron.roots(g, 4, 1):
        (dist,), stats = _launch(BFS, csr, {"root": root})
        want, rounds = ref_graph.bfs(rows, cols, g.n, root)
        got = np.where(np.isfinite(dist), dist, -1).astype(np.int64)
        assert np.array_equal(got, want.numpy())
        assert stats.rounds == rounds and stats.total_drops == 0
        reached = int(g.degrees()[want >= 0].sum())
        assert int(ref_graph.reached_edges(rows, cols, g.n)[root]) == reached


def test_pagerank_reference_matches_the_port(small_graph):
    from repro_torch.sparse.torch_apps import PAGERANK
    g, csr = small_graph
    (rank, _, _), stats = _launch(PAGERANK, csr,
                                  {"damping": 0.85, "iters": 20})
    want = ref_graph.pagerank(g.rows(), g.col_idx.long(), g.n, 0.85, 20)
    gap = float((torch.from_numpy(rank) - want).abs().div(want).max())
    assert gap < 1e-5 and stats.rounds == 20 and stats.total_drops == 0


def test_components_of_a_graph_with_several():
    rows = torch.tensor([0, 1, 1, 2, 3, 4, 6, 7])
    cols = torch.tensor([1, 0, 2, 1, 4, 3, 7, 6])
    assert ref_graph.components(rows, cols, 8).tolist() == [
        0, 0, 0, 3, 3, 5, 6, 6]
    assert ref_graph.reached_edges(rows, cols, 8).tolist() == [
        4, 4, 4, 2, 2, 0, 2, 2]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_reference_matches_the_port(tiny_cell, dtype):
    from repro_torch.core.dispatch import MeshInfo, moe_dcra
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.queues import QueueConfig
    _, _, cfg, tr = tiny_cell("olmoe-moe-fwd")
    cfg["torch_dtype"] = dtype
    stack = moe_inputs.weights(cfg, 3, "cpu")
    means = moe_inputs.topic_means(cfg, tr, stack["router"], 3, "cpu")
    x = moe_inputs.tokens(cfg, tr, 3, 0, "cpu", means)
    params = moe_inputs.layer(stack, 1)
    pk = cfg["packaging"]
    info = MeshInfo(Fabric.virtual(pk["shape"], pk["axes"], device="cpu"))
    out, _, stats = moe_dcra(
        params, x, moe_layer.arch_config(cfg), info,
        queues=QueueConfig(default_iq=None,
                           iq_factors=dict(cfg["queue_factors"])),
        return_stats=True)
    assert stats.total_dropped == 0
    want, near = ref_moe.moe_layer(x, params["router"], params["wg"],
                                   params["wu"], params["wd"],
                                   cfg["num_experts_per_tok"],
                                   moe_layer.TIE_MARGIN)
    err = ref_moe.rel_rms(out.float(), want, ~near)
    assert err < (1e-5 if dtype == "float32" else moe_layer.REL_RMS_LIMIT)


@pytest.mark.parametrize("name", ["kron23-bfs", "kron23-pagerank",
                                  "olmoe-moe-fwd"])
def test_control_is_found_wrong(tiny_cell, name):
    _, _, cfg, tr = tiny_cell(name)
    checks = control.control_checks(cfg, tr, 2 ** 31 + 77, "cpu")
    assert any(not c.ok for c in checks), [(c.name, c.value) for c in
                                           checks]
