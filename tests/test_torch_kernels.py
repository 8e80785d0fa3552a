"""The port's CUDA kernels (routing, histogram, BSR SpMV, grouped matmul,
flash attention) against their plain PyTorch versions.

This file imports torch, numpy and the port only (no jax), so that it
runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

The ``cuda`` tests skip without a card: the kernels have no CPU mode.
The others check the wrappers' device rule on the CPU (a CPU tensor
takes the plain version and launches nothing, any device other than
CUDA or CPU raises), the error bounds the card tests use, and the launch
plans by which the bucket-scatter, reduce, gmm, flash-attention and BSR
wrappers pick a kernel design and launch it, and the rank wrapper's
launch plan.
"""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import histogram as thist
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import route as troute
from repro_torch.kernels import spmv as tspmv

# (S, N, buckets, cap, aux columns, payload width, share of valid tasks):
# N = 0 and 1, N off the rank tile and the scatter tile, S in {1, 7,
# 64}, caps that drop, cap 1 and cap >= N, 1024 buckets, every task
# invalid, no, one and two aux columns, a wide payload
BUCKET_CASES = [(1, 0, 4, 2, 1, 1, 0.9), (1, 1, 4, 2, 1, 1, 0.9),
                (7, 1031, 7, 5, 2, 1, 0.9), (64, 4099, 64, 9, 1, 1, 0.9),
                (3, 2048, 8, 1, 2, 3, 0.9), (7, 2048, 7, 3, 1, 1, 0.0),
                (2, 5003, 1024, 3, 2, 1, 0.9), (3, 4097, 8, 1, 1, 1, 0.9),
                (2, 3000, 5, 3000, 2, 1, 1.0), (4, 0, 16, 2, 1, 1, 0.9),
                (1, 8191, 1, 8000, 1, 1, 0.7), (5, 12289, 37, 40, 2, 3, 0.6),
                (2, 700, 4, 2, 0, 1, 0.8)]


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


def _off_alignment(t):
    """A copy of ``t`` that starts one element into its storage (4 bytes,
    1 for bool)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return flat.view(t.shape).copy_(t)


#: a payload too wide for the staged design's tile staging at any bucket
#: count: what takes the ranked design
WIDE_D = 32


@pytest.mark.cuda
@pytest.mark.parametrize("case", BUCKET_CASES)
@pytest.mark.parametrize("design", ["staged", "ranked"])
@pytest.mark.parametrize("shifted", [False, True])
def test_cuda_bucket_kernels_match_plain(cuda_device, case, design, shifted):
    """The rank kernel and both scatter designs bit-identical to the plain
    versions (admission, empty slots 0 / -1, task_slot -1 for a drop,
    n_drop); the case's payload takes ``staged``, a payload ``WIDE_D``
    wide ``ranked``, on fresh inputs and on copies that start off a
    16-byte boundary alike."""
    s, n, nb, cap, k, d, p = case
    if design == "ranked":
        d = WIDE_D
    assert troute.bucket_scatter_plan(s, n, d, k, nb, cap).path == design
    x, dest, valid, aux = _tasks(n + nb, s, n, nb, k, d, p, cuda_device)
    assert torch.equal(troute.bucket_rank(dest, valid, nb),
                       troute.plain_bucket_rank(dest, valid, nb))
    want = troute.plain_bucket_scatter(x, dest, valid, aux, nb, cap)
    if shifted:
        x, dest, valid = (_off_alignment(t) for t in (x, dest, valid))
        aux = [_off_alignment(a) for a in aux]
    troute.reset_launches()
    assert _same_bucketing(troute.bucket_scatter(x, dest, valid, aux, nb, cap),
                           want)
    torch.cuda.synchronize()
    assert troute.LAUNCHES["bucket_scatter"] == 1
    assert troute.PATHS["bucket_scatter"][design] == 1
    # the staged scatter ranks in its own passes, the ranked one launches
    # the rank kernel where there are tasks
    assert troute.LAUNCHES["bucket_rank"] == (
        1 if design == "ranked" and n else 0)


# (S, N, buckets, share valid, dests): N off the tile with about 1000 and
# 200 tiles a shard (look-back chains across hundreds of tiles), 1024
# buckets, every task in one bucket of 8, every task invalid, dests
# outside [0, nb), N around one tile
RANK_CASES = [(2, 1000 * 4096 + 17, 1, 0.7, "uniform"),
              (3, 200 * 4096 + 5, 64, 0.9, "uniform"),
              (1, 1_000_003, 1024, 0.8, "uniform"),
              (4, 77_777, 8, 1.0, "one"), (3, 50_001, 16, 0.0, "uniform"),
              (2, 60_001, 8, 0.9, "outside"), (5, 1, 1, 1.0, "uniform"),
              (5, 4095, 2, 0.5, "uniform"), (5, 4096, 1, 0.5, "uniform"),
              (5, 4097, 64, 0.5, "uniform")]


def _rank_tasks(seed, s, n, nb, p_valid, dests, device):
    rng = np.random.default_rng(seed)
    if dests == "one":
        dest = np.full((s, n), 3)
    elif dests == "outside":
        dest = rng.integers(-nb, 2 * nb, (s, n))
    else:
        dest = rng.integers(0, nb, (s, n))
    valid = rng.random((s, n)) < p_valid
    return (torch.from_numpy(dest.astype(np.int32)).to(device),
            torch.from_numpy(valid).to(device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", RANK_CASES)
@pytest.mark.parametrize("offset", ["none", "both", "dest", "valid"])
def test_cuda_bucket_rank_matches_plain(cuda_device, case, offset):
    """The lookback rank bit-identical to the plain version on fresh
    inputs, on copies of dest (4 bytes) and valid (1 byte) both one
    element off (tiles shift with them and keep the vector loads), and
    on a copy of either alone (scalar loads)."""
    s, n, nb, p, dests = case
    dest, valid = _rank_tasks(n + nb, s, n, nb, p, dests, cuda_device)
    want = troute.plain_bucket_rank(dest, valid, nb)
    if offset in ("both", "dest"):
        dest = _off_alignment(dest)
    if offset in ("both", "valid"):
        valid = _off_alignment(valid)
    troute.reset_launches()
    got = troute.bucket_rank(dest, valid, nb)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert troute.PATHS["bucket_rank"] == {"lookback": 1}
    assert troute.LAUNCHES["bucket_rank"] == 1


@pytest.mark.cuda
def test_cuda_bucket_rank_launches_share_no_state(cuda_device):
    """Each launch has its own status scratch: two back-to-back launches
    on one stream with another between them, then one launch on each of
    two streams at once, all bit-identical to the plain version, so two
    runs are equal (no atomic decides a rank)."""
    d1, v1 = _rank_tasks(21, 3, 700_001, 64, 0.8, "uniform", cuda_device)
    d2, v2 = _rank_tasks(22, 1, 2_000_003, 1, 0.7, "uniform", cuda_device)
    want1 = troute.plain_bucket_rank(d1, v1, 64)
    want2 = troute.plain_bucket_rank(d2, v2, 1)
    first = troute.bucket_rank(d1, v1, 64)
    other = troute.bucket_rank(d2, v2, 1)
    again = troute.bucket_rank(d1, v1, 64)
    torch.cuda.synchronize()
    assert torch.equal(first, want1) and torch.equal(again, want1)
    assert torch.equal(other, want2)
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()
    with torch.cuda.stream(s1):
        on1 = troute.bucket_rank(d1, v1, 64)
    with torch.cuda.stream(s2):
        on2 = troute.bucket_rank(d2, v2, 1)
    torch.cuda.synchronize()
    assert torch.equal(on1, want1) and torch.equal(on2, want2)


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
    # an input left on the host is refused before any launch
    with pytest.raises(ValueError, match="expected a tensor on"):
        troute.bucket_rank(dest, valid.cpu(), 4)
    with pytest.raises(ValueError, match="expected a tensor on"):
        troute.bucket_scatter(x, dest, valid, [aux[0].cpu()], 4, 2)
    with pytest.raises(ValueError, match="expected a tensor on"):
        troute.bucket_scatter(x, dest.cpu(), valid.cpu(), aux, 4, 2)
    with pytest.raises(ValueError, match="expected a tensor on"):
        troute.reduce_received(dest, x[..., 0].cpu(), 8, "min")


@pytest.mark.cuda
def test_cuda_staged_scatter_is_bit_identical_over_runs(cuda_device):
    """No atomics decide a rank, a slot or the drop count: two runs of the
    staged design with drops give the same bits."""
    x, dest, valid, aux = _tasks(11, 8, 70001, 8, 2, 1, 0.9, cuda_device)
    troute.reset_launches()
    first = troute.bucket_scatter(x, dest, valid, aux, 8, 7000)
    second = troute.bucket_scatter(x, dest, valid, aux, 8, 7000)
    torch.cuda.synchronize()
    assert troute.PATHS["bucket_scatter"] == {"ranked": 0, "staged": 2}
    assert int(first[3].sum()) > 0
    assert _same_bucketing(first, second)


#: a quiet NaN with the sign bit clear and one with it set
POS_NAN, NEG_NAN = torch.tensor([0x7FC00000, -0x00400000],
                                dtype=torch.int32).view(torch.float32)


def _same_reduce(got, want):
    """Equal values, NaN where the other has NaN."""
    return (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.nan_to_num(got), torch.nan_to_num(want)))


# n_local: few outputs (8 copies a block), past the 8 copies (one a
# block), the private threshold and one past it (atomic)
REDUCE_LOCALS = [1, 64, 1537, troute.PRIVATE_MAX_LOCAL,
                 troute.PRIVATE_MAX_LOCAL + 1]


@pytest.mark.cuda
@pytest.mark.parametrize("n_local", REDUCE_LOCALS)
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_reduce_kernel_matches_plain(cuda_device, n_local, aligned):
    """On the design the plan names: min and store bit-identical to the
    plain version, add exact on whole numbers and within 2*k*2^-24 of the
    slot's sum of |v| otherwise; a +NaN and a -NaN in the stream give
    what the plain version gives (+inf under min, 0 under store, NaN under
    add). M off 4, so the 16-byte loads meet a ragged head and tail."""
    rng = np.random.default_rng(n_local)
    s, m = 3, 40_003
    slot = torch.from_numpy(rng.integers(-1, n_local + 2, (s, m)).astype(
        np.int32)).to(cuda_device)
    whole = torch.from_numpy(rng.integers(-9, 10, (s, m)).astype(
        np.float32)).to(cuda_device)
    nan = whole.clone()
    nan[0, 5], nan[1, 17] = POS_NAN, NEG_NAN
    slot[0, 5], slot[1, 17] = 0, n_local - 1
    design = troute.reduce_received_plan(s, m, n_local, aligned).path
    assert design == ("private" if aligned and n_local
                      <= troute.PRIVATE_MAX_LOCAL else "atomic")
    if not aligned:
        slot, whole, nan = (_off_alignment(t) for t in (slot, whole, nan))
    troute.reset_launches()
    for op in troute.REDUCE_OPS:
        for val in (whole, nan):
            got = troute.reduce_received(slot, val, n_local, op)
            want = troute.plain_reduce_received(slot, val, n_local, op)
            assert _same_reduce(got, want), (op, val is nan)
        frac = whole * 0.37
        got = troute.reduce_received(slot, frac, n_local, op)
        want = troute.plain_reduce_received(slot, frac, n_local, op)
        if op != "add":
            assert torch.equal(got, want), op
            continue
        scale = troute.plain_reduce_received(slot, frac.abs(), n_local, "add")
        terms = troute.plain_reduce_received(slot, torch.ones_like(frac),
                                             n_local, "add")
        assert bool(((got - want).abs()
                     <= 2 * terms * 2.0 ** -24 * scale).all())
    torch.cuda.synchronize()
    assert troute.PATHS["reduce_received"][design] == 9


@pytest.mark.cuda
@pytest.mark.parametrize("aligned", [True, False])
def test_cuda_reduce_nan_reads_as_the_reference(cuda_device, aligned):
    """A slot that receives {+NaN, 5} reads +inf under min, one that
    receives {-NaN, 5} reads 0 under store, in either order; add carries
    the NaN."""
    slot = torch.tensor([[0, 0, 1, 1, 2, 2, 3]], dtype=torch.int32,
                        device=cuda_device)
    val = torch.tensor([[0.0, 5.0, 5.0, 0.0, 0.0, 5.0, 2.0]])
    val[0, 0], val[0, 3], val[0, 4] = POS_NAN, POS_NAN, NEG_NAN
    assert bool(torch.signbit(val[0, 4])) and not torch.signbit(val[0, 0])
    val = val.to(cuda_device)
    if not aligned:
        slot, val = _off_alignment(slot), _off_alignment(val)
    inf = float("inf")
    assert troute.reduce_received(slot, val, 4, "min")[0].tolist() == [
        inf, inf, inf, 2.0]
    assert troute.reduce_received(slot, val, 4, "store")[0].tolist() == [
        0.0, 0.0, 0.0, 2.0]
    add = troute.reduce_received(slot, val, 4, "add")[0]
    assert torch.isnan(add[:3]).all() and float(add[3]) == 2.0


# (N, bins): empty, one, off the 16-byte vector, the shared-memory bins
# and the global-memory branch (2^20 bins)
HIST_CASES = [(0, 5), (1, 1), (997, 61), ((1 << 20) + 3, 4096),
              (5003, 1 << 20), (1 << 16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,bins", HIST_CASES)
def test_cuda_histogram_matches_plain(cuda_device, n, bins):
    """Bit-identical (integer atomics are exact in any order), with ids
    below 0 and from ``bins`` on present, at every alignment of the
    first element."""
    rng = np.random.default_rng(n + bins)
    ids = torch.from_numpy(rng.integers(-3, bins + 3, n + 3).astype(
        np.int32)).to(cuda_device)
    thist.reset_launches()
    for off in range(4):
        e = ids[off:off + n]
        assert torch.equal(thist.histogram(e, bins),
                           thist.plain_histogram(e, bins)), off
    torch.cuda.synchronize()
    assert thist.LAUNCHES["histogram"] == (4 if n else 0)


# (R, Kb, BS, Ncb): tests/test_kernels.py's shapes, BS off the warp width
# (all split, BS a multiple of 4); then R = 1 (one slice a block column),
# Kb not divisible by the slices (R 50: 16 slices of Kb 20), R = Kb = 128
# (spmv_csr's grid at BS 16), BS past one 128-row pass, and BS off 4
# (rowblock)
BSR_CASES = [(4, 3, 32, 6), (8, 2, 64, 8), (2, 5, 128, 4), (5, 3, 48, 7),
             (3, 2, 16, 2), (1, 1, 128, 1), (1, 7, 64, 3), (50, 20, 16, 9),
             (128, 128, 16, 128), (2, 3, 256, 4), (5, 3, 30, 7),
             (3, 4, 6, 5)]


def _bsr_inputs(seed, r, kb, bs, ncb, device):
    rng = np.random.default_rng(seed)
    bc = torch.from_numpy(rng.integers(0, ncb, (r, kb)).astype(
        np.int32)).to(device)
    blocks = torch.from_numpy((rng.random((r, kb, bs, bs)) - 0.5).astype(
        np.float32)).to(device)
    x = torch.from_numpy((rng.random(ncb * bs) - 0.5).astype(
        np.float32)).to(device)
    return bc, blocks, x


@pytest.mark.cuda
@pytest.mark.parametrize("r,kb,bs,ncb", BSR_CASES)
def test_cuda_bsr_spmv_matches_plain(cuda_device, r, kb, bs, ncb):
    """Two float32 sums of the same Kb*BS products in other orders:
    within 2*Kb*BS*2^-24 of each row's sum of |a * x| (the plain einsum
    in full float32, TF32 off), on the design the plan names."""
    bc, blocks, x = _bsr_inputs(r * bs + kb, r, kb, bs, ncb, cuda_device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        want = tspmv.plain_bsr_spmv(bc, blocks, x)
        scale = tspmv.plain_bsr_spmv(bc, blocks.abs(), x.abs())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    tspmv.reset_launches()
    got = tspmv.bsr_spmv(bc, blocks, x)
    torch.cuda.synchronize()
    assert tspmv.LAUNCHES["bsr_spmv"] == 1
    design = tspmv.launch_plan(r, kb, bs).path
    assert design == ("split" if bs % 4 == 0 else "rowblock")
    assert tspmv.PATHS[design] == 1 == sum(tspmv.PATHS.values())
    assert bool(((got - want).abs() <= 2 * kb * bs * 2.0 ** -24 * scale)
                .all())


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [32, 30])
def test_cuda_bsr_spmv_reads_a_column_out_of_range_as_zero(cuda_device, bs):
    """A block column below 0 or from Ncb on reads a zero x tile (its block
    is still read): the result equals the plain version's with those
    columns at 0 and their blocks zero, on each design."""
    r, kb, ncb = 6, 5, 4
    bc, blocks, x = _bsr_inputs(bs, r, kb, bs, ncb, cuda_device)
    bc[0, 1], bc[3, 4] = ncb, -1
    keep = (bc >= 0) & (bc < ncb)
    tspmv.reset_launches()
    got = tspmv.bsr_spmv(bc, blocks, x)
    torch.cuda.synchronize()
    assert tspmv.PATHS["split" if bs == 32 else "rowblock"] == 1
    _no_tf32()
    want = tspmv.plain_bsr_spmv(torch.where(keep, bc, 0),
                                blocks * keep[..., None, None], x)
    scale = tspmv.plain_bsr_spmv(torch.where(keep, bc, 0),
                                 blocks.abs() * keep[..., None, None],
                                 x.abs())
    assert bool(((got - want).abs() <= 2 * kb * bs * 2.0 ** -24 * scale)
                .all())


@pytest.mark.cuda
@pytest.mark.parametrize("r,kb,bs", [(128, 128, 32), (3, 10, 128),
                                     (700, 4, 16)])
def test_cuda_bsr_spmv_split_is_bit_identical(cuda_device, r, kb, bs):
    """The split design sums its slices in slice order, without float
    atomics: two runs give the same bits, with many slices and with one."""
    bc, blocks, x = _bsr_inputs(r + kb, r, kb, bs, 16, cuda_device)
    tspmv.reset_launches()
    first = tspmv.bsr_spmv(bc, blocks, x)
    second = tspmv.bsr_spmv(bc, blocks, x)
    torch.cuda.synchronize()
    assert tspmv.PATHS == {"rowblock": 0, "split": 2}
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_cuda_leaf_wrappers_check_their_inputs(cuda_device):
    ids = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    with pytest.raises(TypeError):
        thist.histogram(ids, 4)
    with pytest.raises(ValueError):
        thist.histogram(ids.int().view(2, 4), 4)
    bc = torch.zeros(2, 3, dtype=torch.int32, device=cuda_device)
    blocks = torch.zeros(2, 3, 8, 8, device=cuda_device)
    with pytest.raises(ValueError):
        tspmv.bsr_spmv(bc, blocks, torch.zeros(12, device=cuda_device))
    with pytest.raises(TypeError):
        tspmv.bsr_spmv(bc.long(), blocks, torch.zeros(16, device=cuda_device))
    # block columns or x left on the host are refused before any launch
    with pytest.raises(ValueError, match="expected a tensor on"):
        tspmv.bsr_spmv(bc.cpu(), blocks, torch.zeros(16, device=cuda_device))
    with pytest.raises(ValueError, match="expected a tensor on"):
        tspmv.bsr_spmv(bc, blocks, torch.zeros(16))
    # an x that starts 4 bytes into its storage takes the rowblock kernel
    bc, blocks, x = _bsr_inputs(5, 2, 3, 16, 4, cuda_device)
    xu = torch.zeros(x.numel() + 1, device=cuda_device)[1:]
    xu.copy_(x)
    tspmv.reset_launches()
    got = tspmv.bsr_spmv(bc, blocks, xu)
    torch.cuda.synchronize()
    assert tspmv.PATHS == {"rowblock": 1, "split": 0}
    _no_tf32()
    assert bool(((got - tspmv.plain_bsr_spmv(bc, blocks, x)).abs()
                 <= 2 * 3 * 16 * 2.0 ** -24
                 * tspmv.plain_bsr_spmv(bc, blocks.abs(), x.abs())).all())


# ---------------------------------------------------------------------------
# grouped matmul and flash attention
# ---------------------------------------------------------------------------

def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False


def test_gmm_and_flash_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((64, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 16, 32)).astype(np.float32))
    gids = torch.tensor([2, 0], dtype=torch.int32)
    q = torch.from_numpy(rng.standard_normal((2, 70, 8)).astype(np.float32))
    tgmm.reset_launches()
    tflash.reset_launches()
    assert torch.equal(tgmm.gmm(x, w, gids, rt=32),
                       tgmm.plain_gmm(x, w, gids, 32))
    assert torch.equal(tflash.flash_attention(q, q, q),
                       tflash.plain_flash_attention(q, q, q))
    assert tgmm.LAUNCHES == {"gmm": 0}
    assert tflash.LAUNCHES == {"flash_attention": 0}
    assert not any(tgmm.PATHS.values()) and not any(tflash.PATHS.values())
    with pytest.raises(ValueError, match="cuda or cpu"):
        tgmm.gmm(x.to("meta"), w.to("meta"), gids.to("meta"), rt=32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tflash.flash_attention(q.to("meta"), q.to("meta"), q.to("meta"))


def _gmm_variant(x, w, gids, rt, fault):
    """A float64 grouped matmul, right or with one fault, in x's type."""
    xt = x.double().view(-1, rt, x.shape[1])
    ids = gids.long().clone()
    if fault == "neighbour's expert":
        ids[0] = (ids[0] + 1) % w.shape[0]
    wd = w.double()
    if fault == "last D column dropped":
        xt, wd = xt[..., :-1], wd[:, :-1]
    return torch.einsum("trd,tdf->trf", xt, wd[ids]).reshape(
        x.shape[0], -1).to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", [None, "neighbour's expert",
                                   "last D column dropped"])
def test_gmm_error_bound_rejects_wrong_kernels(dtype, fault):
    """The bound the card tests hold the kernel to admits a correct
    float64 result and refuses each fault."""
    rng = np.random.default_rng(3)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((256, 72)).astype(
        np.float32)).to(dt)
    w = torch.from_numpy(rng.standard_normal((3, 72, 64)).astype(
        np.float32)).to(dt)
    gids = torch.tensor([2, 0, 1, 2], dtype=torch.int32)
    want = tgmm.plain_gmm(x, w, gids, 64)
    err = (_gmm_variant(x, w, gids, 64, fault).float()
           - want.float()).abs()
    held = bool((err <= tgmm.error_bound(x, w, gids, 64, want)).all())
    assert held == (fault is None)


def _flash_variant(q, k, v, causal, fault):
    """The online softmax over 64-row key tiles in float64, right or with
    one fault, in q's type (p rounded to v's type unless the fault says
    otherwise)."""
    bh, s, hd = q.shape
    f64 = torch.float64
    m = torch.full((bh, s), -1e30, dtype=f64)
    l = torch.zeros(bh, s, dtype=f64)
    acc = torch.zeros(bh, s, hd, dtype=f64)
    qi = torch.arange(s)[:, None]
    for k0 in range(0, s, tflash.TILE):
        kt, vt = k[:, k0:k0 + tflash.TILE].double(), v[:, k0:k0 + tflash.TILE]
        sc = q.double() @ kt.transpose(1, 2) * hd ** -0.5
        kj = torch.arange(k0, k0 + kt.shape[1])[None]
        if causal:
            sc = torch.where(
                kj < qi if fault == "diagonal masked" else kj <= qi, sc, -1e30)
        if fault == "first key tile skipped" and k0 == 0:
            sc = torch.where(qi >= tflash.TILE, -1e30, sc)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = (l if fault == "l not rescaled" else l * alpha) + p.sum(-1)
        if fault != "p unrounded":
            p = p.to(v.dtype).double()
        acc = acc * alpha[..., None] + p @ vt.double()
        m = m_new
    return (acc / l.clamp(min=1e-30)[..., None]).to(q.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fault", [None, "p unrounded", "diagonal masked",
                                   "first key tile skipped",
                                   "l not rescaled"])
def test_flash_error_bound_rejects_wrong_kernels(dtype, fault):
    """The bound the card tests hold the kernel to (per element, and in
    bf16 the share against the p-unrounded plain version) admits a
    correct float64 online softmax and refuses each fault that changes
    the result (p unrounded is no fault in float32)."""
    rng = np.random.default_rng(4)
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 256, 64)).astype(
        np.float32)).to(dt) for _ in range(3))
    want = tflash.plain_flash_attention(q, k, v, True)
    got = _flash_variant(q, k, v, True, fault)
    err = (got.float() - want.float()).abs()
    held = bool((err <= tflash.error_bound(q, k, v, True, want)).all())
    if dtype == "bfloat16":
        held = held and tflash.unrounded_share(q, k, v, True, got,
                                               want) <= 0.1
    is_fault = fault is not None and not (fault == "p unrounded"
                                          and dtype == "float32")
    assert held != is_fault


# ---------------------------------------------------------------------------
# launch plans (pure Python: checked here, used by every launch on the card)
# ---------------------------------------------------------------------------

SMEM_LIMIT = 232_448      # shared memory one block may take on an H100

@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s", [1, 100, 4096])
@pytest.mark.parametrize("hd", list(range(8, 129, 8)))
def test_flash_launch_plan(hd, s, dtype):
    """bf16 at every hd that is a multiple of 8 takes wgmma, float32 the
    blocked kernel, unaligned bases the simt kernel; the key tile is TILE
    (the plain version's), one grid axis is BH and the other's q tiles
    cover S once, and the block fits the card's shared memory. (The C
    launchers refuse a plan that differs from the geometry they launch:
    ``test_cuda_kernels_refuse_a_plan_they_do_not_launch``.)"""
    dt = getattr(torch, dtype)
    plan = tflash.launch_plan(6, s, hd, dt)
    assert plan.path == ("wgmma" if dtype == "bfloat16" else "blocked")
    for p in (plan, tflash.launch_plan(6, s, hd, dt, aligned=False)):
        _check_flash_plan(p, 6, s, hd)
    assert p.path == "simt"


def _check_flash_plan(p, bh, s, hd):
    """Properties every flash plan holds, whatever its design."""
    q_rows, keys, width = p.tiles
    assert keys == tflash.TILE
    assert p.smem_bytes <= SMEM_LIMIT and p.stages >= 1
    heads, q_tiles = p.grid[:2] if p.path != "simt" else p.grid[1::-1]
    assert heads == bh and p.grid[2] == 1
    assert (q_tiles - 1) * q_rows < s <= q_tiles * q_rows
    if p.path == "wgmma":      # 64-row consumer warpgroups + a producer
        assert q_rows % 64 == 0 and p.threads == 128 * (q_rows // 64 + 1)
        assert width in (64, 128) and hd <= width < hd + 64
    elif p.path == "blocked":  # 16 x 16 threads of 8 x 4 logits each
        assert (q_rows, width, p.threads, p.stages) == (128, hd, 256, 2)
        assert q_rows * keys == 32 * p.threads
    else:
        assert (q_rows, width) == (tflash.TILE, hd)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_launch_plan_picks_blocked_exactly_for_float32_off_4(dtype):
    """The blocked design is taken exactly for float32 with hd % 4 == 0 at
    aligned bases (its 16-byte copies and loads need both), at every hd
    from 1 to 128; every plan keeps the common properties at a ragged
    S."""
    dt = getattr(torch, dtype)
    for hd in range(1, tflash.MAX_HEAD_DIM + 1):
        for aligned in (True, False):
            p = tflash.launch_plan(3, 333, hd, dt, aligned=aligned)
            assert (p.path == "blocked") == (
                dtype == "float32" and hd % 4 == 0 and aligned), hd
            _check_flash_plan(p, 3, 333, hd)


@pytest.mark.parametrize("hd", [1, 20, 36, 100, 127])
def test_flash_launch_plan_off_the_tma_widths(hd):
    """bf16 with hd off a multiple of 8 (a TMA row stride must be a
    multiple of 16 bytes), or at an unaligned address, stays on the simt
    kernel; float32 takes the blocked kernel at these widths where they
    are multiples of 4, and the simt kernel off 4 or unaligned."""
    bf16, f32 = torch.bfloat16, torch.float32
    assert tflash.launch_plan(2, 300, hd, bf16).path == "simt"
    assert tflash.launch_plan(2, 300, hd, bf16, aligned=False).path == "simt"
    assert tflash.launch_plan(2, 300, 64, bf16, aligned=False).path == "simt"
    assert tflash.launch_plan(2, 300, hd, f32).path == (
        "blocked" if hd % 4 == 0 else "simt")
    assert tflash.launch_plan(2, 300, hd, f32, aligned=False).path == "simt"
    with pytest.raises(TypeError):
        tflash.launch_plan(2, 300, 64, torch.float16)


GMM_PLAN_DF = [(2048, 1024), (72, 200), (64, 64), (36, 96), (48, 90),
               (2050, 1030)]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("d,f", GMM_PLAN_DF)
@pytest.mark.parametrize("rt", [8, 32, 64, 128])
def test_gmm_launch_plan(rt, d, f, dtype):
    """bf16 takes wgmma where rt % 64 == 0 and D, F are multiples of 8,
    float32 the register-blocked GEMM where rt % 64 == 0 and D, F are
    multiples of 4, and everything else the simt kernel; the rows a pass
    reads with one expert's weights never exceed rt (the simt and blocked
    tiles divide rt; the wgmma block's 128 rows are two 64-row halves, and
    rt is a multiple of 64), its tiles cover the output, and it fits the
    card's shared memory; at unaligned bases the same holds on the simt
    kernel."""
    dt = getattr(torch, dtype)
    t = 4 * max(rt, 128)
    plan = tgmm.launch_plan(t, d, f, rt, dt)
    if rt % 64 == 0 and dtype == "bfloat16" and d % 8 == 0 and f % 8 == 0:
        assert plan.path == "wgmma"
    elif rt % 64 == 0 and dtype == "float32" and d % 4 == 0 and f % 4 == 0:
        assert plan.path == "blocked"
    else:
        assert plan.path == "simt"
    unaligned = tgmm.launch_plan(t, d, f, rt, dt, aligned=False)
    assert unaligned.path == "simt"
    for p in (plan, unaligned):
        bm, bn, _ = p.tiles
        pass_rows = 64 if p.path == "wgmma" else bm
        assert pass_rows <= rt and rt % pass_rows == 0
        assert p.smem_bytes <= SMEM_LIMIT
        assert p.stages >= 1 and p.threads % 32 == 0
        blocks = p.grid[0] * p.grid[1] * p.grid[2]
        assert blocks == -(-t // bm) * -(-f // bn)


def test_gmm_launch_plan_refuses():
    """Inputs select the simt kernel (unaligned bases, rt off 64) and never
    a design of the other type; rt off 8 and other types raise."""
    bf16 = torch.bfloat16
    assert tgmm.launch_plan(256, 64, 128, 64, bf16, aligned=False).path == \
        "simt"
    assert tgmm.launch_plan(256, 64, 128, 32, bf16).path == "simt"
    assert tgmm.launch_plan(256, 64, 128, 64, bf16).path == "wgmma"
    assert tgmm.launch_plan(256, 64, 128, 64, torch.float32).path == \
        "blocked"
    with pytest.raises(ValueError, match="multiples of 8"):
        tgmm.launch_plan(24, 64, 128, 12, torch.float32)
    with pytest.raises(TypeError):
        tgmm.launch_plan(256, 64, 128, 64, torch.float64)


@pytest.mark.parametrize("bs", [1, 6, 16, 30, 32, 128, 256])
def test_bsr_launch_plan(bs):
    """The split design is taken exactly for BS a multiple of 4 at
    aligned bases; its slices cover Kb, none empty (Kb below the slice
    count and Kb = 1 included), and give the card at least
    TARGET_BLOCKS blocks wherever Kb allows; the rowblock plan has one
    block a row block; both fit the card's shared memory."""
    for r, kb, aligned in itertools.product(
            [1, 3, 50, 128, 527, 528, 2048], [0, 1, 2, 7, 20, 128],
            [True, False]):
        p = tspmv.launch_plan(r, kb, bs, aligned=aligned)
        assert (p.path == "split") == (bs % 4 == 0 and aligned)
        assert p.threads == 256 and p.stages == 1
        assert p.smem_bytes <= SMEM_LIMIT and p.grid[1:] == (1, 1)
        if p.path == "rowblock":
            assert p.grid[0] == r and p.tiles == (bs, kb, bs)
            continue
        splits = p.grid[0] // r
        assert p.grid[0] == r * splits and splits == tspmv.n_splits(r, kb)
        assert p.tiles == (tspmv.SPLIT_ROWS, -(-kb // splits), bs)
        assert 1 <= splits <= max(kb, 1)
        bounds = [s * kb // splits for s in range(splits + 1)]
        assert bounds[0] == 0 and bounds[-1] == kb
        if kb:
            assert all(hi > lo for lo, hi in zip(bounds, bounds[1:]))
        assert r * splits >= tspmv.TARGET_BLOCKS or splits == max(kb, 1)
        assert splits == 1 or r * splits // 2 < tspmv.TARGET_BLOCKS


@pytest.mark.parametrize("nb", [1, 7, 64, 1024])
@pytest.mark.parametrize("k", [0, 1, 2])
def test_bucket_scatter_plan(nb, k):
    """The staged design is taken exactly where the tile staging fits a
    block and the slots number under 2^31 (no input alignment enters);
    its tiles of STAGE_TILE tasks cover N once (N = 0 and N off the tile
    included); a payload WIDE_D wide always takes ranked, which has one
    thread a task; both fit the card's shared memory. (The
    C launchers refuse any other geometry:
    ``test_cuda_kernels_refuse_a_plan_they_do_not_launch``.)"""
    for s, n, d, cap in itertools.product(
            [1, 7, 64], [0, 1, 4095, 4096, 4097, 2_235_449],
            [1, 2, 3, 20, 26, WIDE_D], [1, 9, 139_720, 1 << 22]):
        p = troute.bucket_scatter_plan(s, n, d, k, nb, cap)
        smem = troute.staged_smem(nb, d, k)
        fits = smem <= SMEM_LIMIT and nb * cap < 2 ** 31
        assert (p.path == "staged") == fits
        if d == WIDE_D:
            assert p.path == "ranked"
        assert p.smem_bytes <= SMEM_LIMIT and p.stages == 1
        assert p.grid[1:] == (s, 1) and p.tiles[1:] == (nb, d)
        rows = p.tiles[0]
        assert (p.grid[0] - 1) * rows < n <= p.grid[0] * rows or \
            n == p.grid[0] == 0
        if p.path == "staged":
            assert (rows, p.threads, p.smem_bytes) == (troute.STAGE_TILE,
                                                       256, smem)
        else:
            assert (rows, p.threads, p.smem_bytes) == (256, 256, 0)
    # every path's shapes (D 1, k 1-2, up to 1024 buckets) fit
    assert troute.bucket_scatter_plan(64, 10, 1, 2, 1024, 1).path == "staged"


RANK_PLAN_NS = [0, 1, troute.RANK_TILE - 1, troute.RANK_TILE,
                troute.RANK_TILE + 1, 128_306_514]


@pytest.mark.parametrize("nb", [1, 2, 64, 1024])
@pytest.mark.parametrize("s", [1, 7, 64])
def test_bucket_rank_plan(s, nb):
    """One design, lookback: each shard's row in ceil((N + 3) / RANK_TILE)
    tiles (the first may start up to 3 tasks before the row so that tiles
    start on a 16-byte boundary of dest), which cover the row whatever
    that shift; one 256-thread block a tile, S * tiles in all, in one
    grid row under 2^31; the block's shared memory (keys, per-warp counts,
    aggregate and prefix) fits; the status scratch is a counter and a pad,
    a 64-bit word a tile and, above one bucket, an int32 prefix and a
    uint16 aggregate a bucket a tile (rows of aggregates padded to 8
    buckets): at most 17 % of the bytes its tiles' tasks move. N = 0
    launches nothing. (The C launcher refuses
    any other geometry:
    ``test_cuda_kernels_refuse_a_plan_they_do_not_launch``.)"""
    tile = troute.RANK_TILE
    for n in RANK_PLAN_NS:
        p = troute.bucket_rank_plan(s, n, nb)
        tiles = p.tiles[2]
        assert p.path == "lookback" and p.tiles[:2] == (tile, nb)
        if n == 0:
            assert tiles == p.grid[0] == 0
        else:
            assert (tiles - 1) * tile < n + 3 <= tiles * tile
            assert all(tiles * tile - shift >= n for shift in range(4))
        assert p.grid == (s * tiles, 1, 1) and p.grid[0] < 2 ** 31
        assert (p.threads, p.stages) == (256, 1)
        assert p.smem_bytes == troute.rank_smem(nb) <= SMEM_LIMIT
        assert p.smem_bytes >= 4 * (tile + 8 * nb)
        scratch = troute.rank_scratch_ints(p)
        if nb == 1:
            assert scratch == 2 + 2 * s * tiles
        else:   # the uint16 aggregates from a 16-byte boundary, rows of 8
            head = 2 + 2 * s * tiles + s * tiles * nb
            row = -(-nb // 8) * 8
            assert scratch == -(-head // 4) * 4 + s * tiles * row // 2
        assert 4 * (scratch - 2) <= 0.17 * 9 * tile * s * tiles + 16


def test_bucket_rank_plan_refuses():
    for bad in [dict(n_buckets=0), dict(n_buckets=troute.MAX_BUCKETS + 1),
                dict(n=-1), dict(s=-1), dict(n=troute.RANK_MAX_TASKS + 1)]:
        args = dict(s=2, n=10, n_buckets=4)
        args.update(bad)
        with pytest.raises(ValueError):
            troute.bucket_rank_plan(**args)


def test_bucket_scatter_plan_refuses():
    for bad in [dict(n_buckets=0), dict(n_buckets=troute.MAX_BUCKETS + 1),
                dict(cap=0), dict(n=-1), dict(d=-1)]:
        args = dict(s=2, n=10, d=1, k=1, n_buckets=4, cap=3)
        args.update(bad)
        with pytest.raises(ValueError):
            troute.bucket_scatter_plan(**args)


def test_reduce_received_plan():
    """The private design is taken exactly for aligned inputs with
    1 <= n_local <= PRIVATE_MAX_LOCAL; its chunks (a multiple of 4
    entries) cover M, none empty past the first, at most TARGET_BLOCKS
    blocks over the shards and no more chunks than ceil(M /
    PRIVATE_MIN_CHUNK); 8 copies a block while they fit in
    WARP_COPY_BYTES, else one; atomic has one thread an entry."""
    t = troute.PRIVATE_MAX_LOCAL
    for s, m, n_local, aligned in itertools.product(
            [1, 3, 8, 64, 2000], [0, 1, 3, 4097, 40_003, 8_388_608],
            [0, 1, 64, 1536, 1537, t, t + 1, 65_536], [True, False]):
        p = troute.reduce_received_plan(s, m, n_local, aligned)
        assert (p.path == "private") == (aligned and 1 <= n_local <= t)
        assert p.smem_bytes <= SMEM_LIMIT and p.stages == 1
        assert p.grid[1:] == (s, 1) and p.threads == 256
        rows, local, copies = p.tiles
        assert local == n_local
        if p.path == "atomic":
            assert rows == 256 and p.smem_bytes == 0
            assert (p.grid[0] - 1) * 256 < m <= p.grid[0] * 256 or \
                m == p.grid[0] == 0
            continue
        chunks = p.grid[0]
        assert rows % 4 == 0 and chunks >= 1 and chunks * rows >= m
        assert (chunks - 1) * rows < m or chunks == 1
        assert chunks == 1 or chunks * s <= troute.TARGET_BLOCKS + s
        assert chunks == 1 or (chunks - 1) * troute.PRIVATE_MIN_CHUNK < m
        assert copies == (8 if 32 * n_local <= troute.WARP_COPY_BYTES
                          else 1)
        assert p.smem_bytes == 4 * copies * n_local


def test_reduce_received_plan_refuses():
    for bad in [(-1, 5, 4), (2, -1, 4), (2, 5, -1)]:
        with pytest.raises(ValueError):
            troute.reduce_received_plan(*bad)


def test_bsr_takes_the_plain_version_on_cpu():
    bc, blocks, x = _bsr_inputs(0, 3, 2, 8, 4, "cpu")
    tspmv.reset_launches()
    assert torch.equal(tspmv.bsr_spmv(bc, blocks, x),
                       tspmv.plain_bsr_spmv(bc, blocks, x))
    assert tspmv.LAUNCHES == {"bsr_spmv": 0}
    assert not any(tspmv.PATHS.values())


# (T, D, F, E, rt, ft, dtype): the CPU tier's shapes, rt = 8 / 32 / 64,
# D off the 16-deep step, F off the 64-column tile, one expert, bf16; then
# the wgmma design at rt 64 and 128 with D and F off 64, the blocked one
# with F off its 256 columns, each type's simt fallback at rt 64, and
# wgmma with an odd count of 64-row halves (T = 320) and with 128-row
# blocks straddling row tiles (rt = 192)
GMM_CUDA_CASES = [
    (256, 64, 128, 2, 128, 128, "float32"), (512, 32, 256, 4, 128, 128,
                                             "float32"),
    (384, 128, 128, 3, 128, 128, "float32"), (64, 40, 64, 3, 8, 128,
                                              "float32"),
    (192, 72, 128, 1, 64, 128, "float32"), (320, 48, 96, 2, 32, 128,
                                            "bfloat16"),
    (256, 64, 128, 2, 128, 128, "bfloat16"), (128, 2048, 192, 5, 64, 64,
                                              "float32"),
    (384, 72, 200, 3, 64, 200, "bfloat16"), (512, 200, 136, 2, 128, 136,
                                             "bfloat16"),
    (256, 1000, 1048, 4, 64, 1048, "bfloat16"), (384, 72, 200, 3, 64, 200,
                                                 "float32"),
    (192, 36, 96, 2, 64, 96, "bfloat16"), (192, 36, 90, 2, 64, 90,
                                           "float32"),
    (320, 64, 128, 3, 64, 128, "bfloat16"), (768, 64, 256, 3, 192, 128,
                                             "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", GMM_CUDA_CASES)
def test_cuda_gmm_matches_plain(cuda_device, case):
    t, d, f, e, rt, ft, dtype = case
    rng = np.random.default_rng(t + d + f)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.standard_normal((t, d)).astype(np.float32)).to(
        cuda_device, dt)
    w = torch.from_numpy(rng.standard_normal((e, d, f)).astype(
        np.float32)).to(cuda_device, dt)
    gids = torch.from_numpy(rng.integers(0, e, t // rt).astype(np.int32)).to(
        cuda_device)
    _no_tf32()
    want = tgmm.plain_gmm(x, w, gids, rt)
    tgmm.reset_launches()
    got = tgmm.gmm(x, w, gids, rt=rt, ft=ft)
    torch.cuda.synchronize()
    assert tgmm.LAUNCHES["gmm"] == 1
    design = tgmm.launch_plan(t, d, f, min(rt, t), dt).path
    assert tgmm.PATHS[design] == 1 == sum(tgmm.PATHS.values())
    assert got.dtype == dt and got.shape == (t, f)
    tol = tgmm.error_bound(x, w, gids, rt, want)
    assert bool(((got.float() - want.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_cuda_gmm_checks_its_inputs(cuda_device):
    x = torch.zeros(128, 16, device=cuda_device)
    w = torch.ones(2, 16, 192, device=cuda_device)
    gids = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="column tiles"):
        tgmm.gmm(x, w, gids)                              # F % 128 != 0
    with pytest.raises(ValueError, match="multiples of 8"):
        tgmm.gmm(x[:12], w, gids, rt=12, ft=64)
    with pytest.raises(TypeError):
        tgmm.gmm(x, w.bfloat16(), gids, ft=64)
    with pytest.raises(TypeError):
        tgmm.gmm(x.double(), w.double(), gids, ft=64)
    with pytest.raises(ValueError, match="expected a tensor on"):
        tgmm.gmm(x, w, gids.cpu(), ft=64)
    # a group id outside [0, E) gives zero rows, never an out-of-bounds
    # read, on every design (rt 32 selects the simt kernel)
    for dt, rt, path in ((torch.float32, 64, "blocked"),
                         (torch.float32, 32, "simt"),
                         (torch.bfloat16, 64, "wgmma"),
                         (torch.bfloat16, 32, "simt")):
        tgmm.reset_launches()
        out = tgmm.gmm((x + 1).to(dt), w.to(dt),
                       torch.tensor([5] * (64 // rt) + [0] * (64 // rt),
                                    dtype=torch.int32, device=cuda_device),
                       rt=rt, ft=64)
        torch.cuda.synchronize()
        assert tgmm.PATHS[path] == 1
        assert bool((out[:64] == 0).all()) and bool((out[64:] == 16).all())


# (BH, S, hd, dtype, causal): one causal tile, ragged S, hd off 16, hd 128;
# then bf16 on wgmma at hd 64 / 96 / 128 and S 128 / 300 / 1024, causal
# and not, and bf16 with hd off 8 (simt); then float32 on the blocked
# kernel at a ragged S past one 128-row tile, hd 4 / 100 / 128, non-causal
# and S = 1, and float32 with hd off 4 (simt)
FLASH_CUDA_CASES = [(4, 128, 64, "float32", True), (4, 128, 64, "float32",
                                                    False),
                    (4, 64, 128, "float32", True), (2, 100, 80, "float32",
                                                    True),
                    (4, 256, 128, "bfloat16", True), (4, 256, 128, "bfloat16",
                                                      False),
                    (1, 1, 8, "float32", True), (3, 200, 32, "bfloat16", False)
                    ] + [(2, s, hd, "bfloat16", causal) for hd in (64, 96, 128)
                         for s in (128, 300, 1024) for causal in (True, False)
                         ] + [(2, 100, 20, "bfloat16", True),
                              (1, 1, 8, "bfloat16", True)
                              ] + [(2, 300, 128, "float32", True),
                                   (3, 200, 4, "float32", True),
                                   (2, 300, 100, "float32", False),
                                   (2, 1000, 128, "float32", False),
                                   (1, 1, 4, "float32", False),
                                   (2, 100, 30, "float32", True),
                                   (2, 129, 7, "float32", False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CUDA_CASES)
def test_cuda_flash_attention_matches_plain(cuda_device, case):
    bh, s, hd, dtype, causal = case
    rng = np.random.default_rng(bh * s + hd)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, hd)).astype(
        np.float32)).to(cuda_device, getattr(torch, dtype)) for _ in range(3))
    _no_tf32()
    want = tflash.plain_flash_attention(q, k, v, causal)
    tflash.reset_launches()
    got = tflash.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert tflash.LAUNCHES["flash_attention"] == 1
    design = tflash.launch_plan(bh, s, hd, q.dtype).path
    assert tflash.PATHS[design] == 1 == sum(tflash.PATHS.values())
    assert design == ("wgmma" if dtype == "bfloat16" and hd % 8 == 0
                      else "blocked" if dtype == "float32" and hd % 4 == 0
                      else "simt")
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = tflash.error_bound(q, k, v, causal, want)
    assert bool(((got.float() - want.float()).abs() <= tol).all())
    if dtype == "bfloat16" and s > 1:  # p rounded as the plain version does
        assert tflash.unrounded_share(q, k, v, causal, got, want) <= 0.1
    ones = tflash.flash_attention(q, k, torch.ones_like(v), causal)
    assert bool(((ones.float() - 1).abs() <= 1e-5).all())


@pytest.mark.cuda
def test_cuda_flash_attention_checks_its_inputs(cuda_device):
    q = torch.zeros(2, 64, 160, device=cuda_device)
    with pytest.raises(ValueError, match="hd <= 128"):
        tflash.flash_attention(q, q, q)
    q = q[..., :64].contiguous()
    with pytest.raises(TypeError):
        tflash.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        tflash.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                               q, q)
    with pytest.raises(ValueError, match="expected a tensor on"):
        tflash.flash_attention(q, q.cpu(), q)
    # a bf16 view that starts 2 bytes into its storage takes the simt
    # kernel (TMA needs 16-byte aligned bases)
    buf = torch.randn(2 * 64 * 64 + 1, device=cuda_device).bfloat16()
    qu = buf[1:].view(2, 64, 64)
    tflash.reset_launches()
    got = tflash.flash_attention(qu, qu, qu)
    torch.cuda.synchronize()
    assert tflash.PATHS["simt"] == 1
    want = tflash.plain_flash_attention(qu, qu, qu)
    assert bool(((got.float() - want.float()).abs()
                 <= tflash.error_bound(qu, qu, qu, True, want)).all())
    # so does a float32 view that starts 4 bytes into its storage
    buf = torch.randn(2 * 200 * 64 + 1, device=cuda_device)
    qu = buf[1:].view(2, 200, 64)
    tflash.reset_launches()
    got = tflash.flash_attention(qu, qu, qu)
    torch.cuda.synchronize()
    assert tflash.PATHS["simt"] == 1
    _no_tf32()
    want = tflash.plain_flash_attention(qu, qu, qu)
    assert bool(((got - want).abs()
                 <= tflash.error_bound(qu, qu, qu, True, want)).all())


@pytest.mark.cuda
def test_cuda_kernels_refuse_a_plan_they_do_not_launch(cuda_device):
    """The C launchers compute their own geometry and refuse a launch plan
    that differs from it in any field, so ``launch_plan`` (checked on the
    CPU) is what runs on the card: ``chip_smoke.plans_refused`` launches
    every design of the bucket rank (1), the bucket scatter (2), the
    reduce (2), gmm (4), flash attention (4) and the BSR SpMV (2) with its
    own plan and with each of the plan's 7 fields altered."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    assert chip_smoke.plans_refused(cuda_device) == 15 * 7

