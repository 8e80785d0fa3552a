"""Fixtures of the benchmark's CPU tests: each cell of ``BENCHMARK.json``
with its configuration cut to a size a test can hold (the same files,
the sizes overridden), and the ``cuda`` marker for the tests that need
the card."""
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the PyTorch port's kernels); "
        "skips without one")


#: per driver, the sizes a CPU test runs at
TINY = {
    "graph_app": ({"scale": 10, "shards": 8}, {}),
    "moe_layer": ({"hidden_size": 64, "intermediate_size": 32,
                   "num_experts": 16, "num_experts_per_tok": 4,
                   "num_hidden_layers": 2,
                   "packaging": {"shape": [2, 4, 1],
                                 "axes": ["data", "expert", "tp"]},
                   "queue_factors": {"dispatch": 4.0, "portal": 1.0,
                                     "expert": 1.0}},
                  {"batch": 2, "seq_len": 16, "sample_range": 8}),
}


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name) -> (spec, cell, config, traffic)``: the cell's
    own files with the sizes of :data:`TINY`."""
    from dcra_bench import harness

    def make(name):
        spec = harness.load_spec()
        cell = harness.find_cell(spec, name)
        cfg = harness.load_config(spec, cell["config"])
        tr = harness.load_traffic(cell["traffic"])
        c, t = TINY[cfg["driver"]]
        cfg.update(c)
        tr.update(t)
        return spec, cell, cfg, tr
    return make


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
