"""The port's CUDA routing kernels against their plain PyTorch versions.

This file imports torch, numpy and the port only (no jax), so that it
runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

The ``cuda`` tests skip without a card: the kernels have no CPU mode.
The others check the wrappers' device rule on the CPU: a CPU tensor
takes the plain version and launches nothing, any device other than
CUDA or CPU raises.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import route as troute

# (S, N, buckets, cap, aux columns, payload width, share of valid tasks):
# N = 0 and 1, N off the rank tile, S in {1, 7, 64}, caps that drop,
# every task invalid, one and two aux columns
BUCKET_CASES = [(1, 0, 4, 2, 1, 1, 0.9), (1, 1, 4, 2, 1, 1, 0.9),
                (7, 1031, 7, 5, 2, 1, 0.9), (64, 4099, 64, 9, 1, 1, 0.9),
                (3, 2048, 8, 1, 2, 3, 0.9), (7, 2048, 7, 3, 1, 1, 0.0)]


def _tasks(seed, s, n, nb, k, d, p_valid, device="cpu"):
    rng = np.random.default_rng(seed)
    dest = torch.from_numpy(rng.integers(0, nb, (s, n)).astype(np.int32))
    valid = torch.from_numpy(rng.random((s, n)) < p_valid)
    x = torch.from_numpy(rng.random((s, n, d)).astype(np.float32))
    aux = [torch.from_numpy(rng.integers(-1, 1 << 20, (s, n)).astype(
        np.int32)) for _ in range(k)]
    return (x.to(device), dest.to(device), valid.to(device),
            [a.to(device) for a in aux])


def _same_bucketing(got, want):
    return (torch.equal(got[0], want[0]) and len(got[1]) == len(want[1])
            and all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
            and torch.equal(got[2], want[2]) and torch.equal(got[3], want[3]))


def test_wrappers_take_the_plain_version_on_cpu():
    x, dest, valid, aux = _tasks(1, 3, 301, 5, 2, 2, 0.8)
    troute.reset_launches()
    assert torch.equal(troute.bucket_rank(dest, valid, 5),
                       troute.plain_bucket_rank(dest, valid, 5))
    assert _same_bucketing(troute.bucket_scatter(x, dest, valid, aux, 5, 4),
                           troute.plain_bucket_scatter(x, dest, valid, aux,
                                                       5, 4))
    slot, val = dest * 3 - 1, x[..., 0].contiguous()
    for op in troute.REDUCE_OPS:
        assert torch.equal(troute.reduce_received(slot, val, 12, op),
                           troute.plain_reduce_received(slot, val, 12, op))
    assert set(troute.LAUNCHES.values()) == {0}


def test_wrappers_refuse_other_devices():
    x, dest, valid, aux = _tasks(2, 2, 9, 3, 1, 1, 0.8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        troute.bucket_rank(dest, valid, 3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        troute.bucket_scatter(x, dest, valid, aux, 3, 2)
    with pytest.raises(ValueError, match="cuda or cpu"):
        troute.reduce_received(dest, x[..., 0], 4, "min")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", BUCKET_CASES)
def test_cuda_bucket_kernels_match_plain(cuda_device, case):
    s, n, nb, cap, k, d, p = case
    x, dest, valid, aux = _tasks(n + nb, s, n, nb, k, d, p, cuda_device)
    troute.reset_launches()
    assert torch.equal(troute.bucket_rank(dest, valid, nb),
                       troute.plain_bucket_rank(dest, valid, nb))
    assert _same_bucketing(troute.bucket_scatter(x, dest, valid, aux, nb, cap),
                           troute.plain_bucket_scatter(x, dest, valid, aux,
                                                       nb, cap))
    torch.cuda.synchronize()
    assert troute.LAUNCHES["bucket_scatter"] == 1
    assert troute.LAUNCHES["bucket_rank"] == (2 if n else 0)


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["min", "store", "add"])
def test_cuda_reduce_kernel_matches_plain(cuda_device, op):
    """min and store bit-identical; add exact on whole numbers (no f32 sum
    of them rounds below 2^24), else within 2*k*2^-24 of the slot's sum
    of |v| for a slot of k terms (two atomic orders of one f32 sum)."""
    rng = np.random.default_rng(3)
    slot = torch.from_numpy(rng.integers(-1, 70, (5, 3001)).astype(
        np.int32)).to(cuda_device)
    whole = torch.from_numpy(rng.integers(-9, 10, (5, 3001)).astype(
        np.float32)).to(cuda_device)
    assert torch.equal(troute.reduce_received(slot, whole, 64, op),
                       troute.plain_reduce_received(slot, whole, 64, op))
    frac = whole * 0.37
    got = troute.reduce_received(slot, frac, 64, op)
    want = troute.plain_reduce_received(slot, frac, 64, op)
    if op != "add":
        assert torch.equal(got, want)
        return
    scale = troute.plain_reduce_received(slot, frac.abs(), 64, "add")
    terms = troute.plain_reduce_received(slot, torch.ones_like(frac), 64,
                                         "add")
    assert bool(((got - want).abs() <= 2 * terms * 2.0 ** -24 * scale).all())


@pytest.mark.cuda
def test_cuda_wrappers_check_their_inputs(cuda_device):
    x, dest, valid, aux = _tasks(4, 2, 64, 4, 1, 1, 0.8, cuda_device)
    with pytest.raises(TypeError):
        troute.bucket_rank(dest.long(), valid, 4)
    with pytest.raises(ValueError):
        troute.bucket_rank(dest, valid, troute.MAX_BUCKETS + 1)
    with pytest.raises(ValueError):
        troute.bucket_scatter(x.transpose(0, 1).contiguous().transpose(
            0, 1), dest, valid, aux, 4, 2)
    with pytest.raises(ValueError):
        troute.bucket_scatter(x, dest, valid, aux, 4, 0)
    with pytest.raises(TypeError):
        troute.reduce_received(dest, x[..., 0].double(), 8, "min")
