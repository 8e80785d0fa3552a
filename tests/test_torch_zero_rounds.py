"""Zero-round launches of the port's graph apps, pinned (a deliberate
difference: the reference raises ``IndexError`` while tracing a launch
of zero rounds, at ``repro/sparse/program.py:915``, a defect of the
frozen package).

``max_rounds=0`` (BFS, SSSP, WCC, k-core) and ``iters=0`` (PageRank), in
both round modes, on flat and pod fabrics: the port returns each app's
initial state, which is the reference's numpy oracle's state before its
first round (``repro/sparse/ref.py``, numpy-only, on the reference's own
graph from ``repro/sparse/datasets.py``), with 0 rounds and empty message
and drop streams, as the analytic twin counts the same launch.
"""
import numpy as np
import pytest

from repro.sparse import datasets, ref
from repro_torch.core.fabric import Fabric
from repro_torch.sparse.csr import CSR
from repro_torch.sparse.options import LaunchOptions
from repro_torch.sparse.program import program_app_stats
from repro_torch.sparse.torch_apps import (BFS, KCORE, PAGERANK, SSSP, WCC,
                                           dcra_bfs, dcra_kcore,
                                           dcra_pagerank, dcra_sssp,
                                           dcra_wcc)

ROOT, K = 5, 4


def _initial(g, app):
    """The reference oracle's state before its first round on the
    reference's graph ``g``, and the twin's program and params."""
    ids = np.arange(g.n)
    if app == "bfs":
        return np.where(ref.bfs_ref(g, ROOT) == 0, 0, -1), BFS, {"root": ROOT}
    if app == "sssp":
        assert ref.sssp_ref(g, ROOT)[ROOT] == 0
        return np.where(ids == ROOT, 0.0, np.inf), SSSP, {"root": ROOT}
    if app == "wcc":
        assert np.all(ref.wcc_ref(g) <= ids)   # labels only fall from ids
        return ids, WCC, {}
    if app == "kcore":
        return ref.kcore_ref(g, 0), KCORE, {"k": K}
    return ref.pagerank_ref(g, iters=0), PAGERANK, {"iters": 0,
                                                     "damping": 0.85}


def _launch(g, app, fabric, options):
    if app == "bfs":
        return dcra_bfs(g, ROOT, fabric, options=options, max_rounds=0)
    if app == "sssp":
        return dcra_sssp(g, ROOT, fabric, options=options, max_rounds=0)
    if app == "wcc":
        return dcra_wcc(g, fabric, options=options, max_rounds=0)
    if app == "kcore":
        return dcra_kcore(g, K, fabric, options=options, max_rounds=0)
    return dcra_pagerank(g, fabric, iters=0, options=options)


@pytest.mark.parametrize("mode", ["lockstep", "pipelined"])
@pytest.mark.parametrize("app", ["bfs", "sssp", "wcc", "kcore", "pagerank"])
def test_zero_round_launch_returns_the_initial_state(app, mode):
    jg = datasets.erdos_renyi(n=200, avg_degree=6, seed=3)
    want, prog, params = _initial(jg, app)
    g = CSR.from_arrays(jg.row_ptr, jg.col_idx, jg.values)
    for fabric, opts in (
            (Fabric.fake(4, device="cpu"), LaunchOptions(round_mode=mode)),
            (Fabric.virtual((2, 2), ("pod", "data"), device="cpu"),
             LaunchOptions(round_mode=mode, pod_axis="pod"))):
        state, stats = _launch(g, app, fabric, opts)
        if app == "pagerank":       # 1/n in float32
            np.testing.assert_allclose(state, want, rtol=1e-6)
        else:
            assert np.array_equal(state, want)
        assert stats.rounds == 0
        assert stats.messages.size == 0 and stats.drops.size == 0
    twin = program_app_stats(prog, g, 4, params=params, max_rounds=0)
    assert twin.rounds == 0
    assert twin.messages.size == 0 and twin.drops.size == 0
