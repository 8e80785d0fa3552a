"""The generators: the same seed gives the same inputs, another seed other
ones, and the kron graph has the shape its configuration states."""
import numpy as np
import pytest
import torch

from dcra_bench.gen import kron, moe_inputs, seeds

BIG_SEEDS = (0, 7, 2 ** 31 + 17, 2 ** 40 + 3)


def _host(g):
    return [np.asarray(a) for a in g.host()]


@pytest.mark.parametrize("seed", BIG_SEEDS)
def test_kron_same_seed_same_graph(seed):
    a = kron.kron(9, 16, (0.57, 0.19, 0.19), seed, "cpu")
    b = kron.kron(9, 16, (0.57, 0.19, 0.19), seed, "cpu")
    for x, y in zip(_host(a), _host(b)):
        assert np.array_equal(x, y)
    assert kron.roots(a, 64, seed) == kron.roots(b, 64, seed)


def test_kron_other_seed_other_graph():
    a = kron.kron(9, 16, (0.57, 0.19, 0.19), 1, "cpu")
    b = kron.kron(9, 16, (0.57, 0.19, 0.19), 2, "cpu")
    assert a.nnz != b.nnz or not torch.equal(a.col_idx, b.col_idx)
    assert kron.roots(a, 64, 1) != kron.roots(b, 64, 2)


def test_kron_is_a_simple_undirected_weighted_graph():
    g = kron.kron(10, 16, (0.57, 0.19, 0.19), 5, "cpu")
    rows, cols = g.rows(), g.col_idx.long()
    assert g.n == 1 << 10
    assert not bool((rows == cols).any()), "self-loop kept"
    key = rows * g.n + cols
    assert bool((key[1:] > key[:-1]).all()), "not sorted or duplicated"
    back = torch.sort(cols * g.n + rows).values
    assert torch.equal(back, key), "not symmetric"
    # the weight of (u, v) is the weight of (v, u)
    w_back = g.values[torch.searchsorted(key, cols * g.n + rows)]
    assert torch.equal(w_back, g.values)
    assert float(g.values.min()) >= 1 and float(g.values.max()) <= 255
    assert torch.equal(g.values, g.values.round())
    # a power-law graph: the largest degree far above the mean
    deg = g.degrees().float()
    assert float(deg.max()) > 10 * float(deg[deg > 0].mean())


def test_roots_have_edges_and_are_distinct():
    g = kron.kron(10, 16, (0.57, 0.19, 0.19), 3, "cpu")
    r = kron.roots(g, 64, 3)
    assert len(set(r)) == 64
    assert all(int(g.degrees()[v]) > 0 for v in r)


def test_moe_inputs_from_seed():
    cfg = {"hidden_size": 32, "intermediate_size": 16, "num_experts": 8,
           "num_hidden_layers": 3, "initializer_range": 0.02,
           "torch_dtype": "bfloat16"}
    tr = {"batch": 2, "seq_len": 4, "topics": 4, "zipf_s": 0.25}
    a = moe_inputs.weights(cfg, 2 ** 33, "cpu")
    b = moe_inputs.weights(cfg, 2 ** 33, "cpu")
    c = moe_inputs.weights(cfg, 2 ** 33 + 1, "cpu")
    assert a["wg"].dtype == torch.bfloat16
    assert tuple(a["wd"].shape) == (3, 8, 16, 32)
    assert tuple(moe_inputs.layer(a, 2)["router"].shape) == (32, 8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wg"], c["wg"])
    means = moe_inputs.topic_means(cfg, tr, a["router"], 11, "cpu")
    assert torch.equal(means, moe_inputs.topic_means(cfg, tr, a["router"],
                                                     11, "cpu"))
    x0 = moe_inputs.tokens(cfg, tr, 11, 0, "cpu", means)
    assert torch.equal(x0, moe_inputs.tokens(cfg, tr, 11, 0, "cpu", means))
    assert not torch.equal(x0, moe_inputs.tokens(cfg, tr, 11, 1, "cpu",
                                                 means))
    assert tuple(x0.shape) == (2, 4, 32)


def test_topic_means_give_zipf_offsets_in_every_layer():
    """A topic's mean has, in every layer's router, the logits ``s
    ln(1/r)`` (centred) over the experts in some order: the same set of
    offsets for every topic, layer and seed."""
    cfg = {"hidden_size": 64, "intermediate_size": 8, "num_experts": 8,
           "num_hidden_layers": 4, "initializer_range": 0.02,
           "torch_dtype": "float32"}
    tr = {"topics": 3, "zipf_s": 0.5}
    want = -0.5 * torch.log(torch.arange(1, 9, dtype=torch.float64))
    want = torch.sort(want - want.mean()).values
    for seed in (1, 2 ** 31 + 3):
        router = moe_inputs.weights(cfg, seed, "cpu")["router"]
        means = moe_inputs.topic_means(cfg, tr, router, seed, "cpu")
        logits = torch.einsum("td,lde->tle", means.double(), router.double())
        got = torch.sort(logits, dim=-1).values
        assert torch.allclose(got, want.expand_as(got), atol=1e-4)
    topics = {moe_inputs.topic_of(tr, 5, s) for s in range(40)}
    assert topics == {0, 1, 2}


def test_sample_and_sub_seeds():
    assert seeds.sample(100, 8, 5, 1) == seeds.sample(100, 8, 5, 1)
    assert seeds.sample(100, 8, 5, 1) != seeds.sample(100, 8, 6, 1)
    assert seeds.sample(3, 8, 5, 1) == [0, 1, 2]
    s = {seeds.sub_seed(2 ** 31 + 5, t) for t in range(50)}
    assert len(s) == 50 and all(0 <= v < 2 ** 63 for v in s)
