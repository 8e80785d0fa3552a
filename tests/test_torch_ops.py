"""The port's leaf kernels and their host side against the JAX package, on
the CPU.

The histogram, BSR-SpMV, grouped-matmul and flash-attention wrappers run
their plain PyTorch versions on CPU tensors; these are held against the
Pallas kernels (interpret mode) and the ``kernels/ref.py`` oracles on the
same numpy inputs. The host
side (``csr_to_bsr``, ``histogram_data``, the numpy oracles of the
add-reduce and stream apps) must be byte-identical to the reference.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ref as jkref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.histogram import histogram_pallas
from repro.kernels.moe_gmm import gmm_pallas
from repro.kernels.spmv import bsr_spmv_pallas
from repro.kernels.spmv import csr_to_bsr as j_csr_to_bsr
from repro.kernels.spmv import spmv_csr as j_spmv_csr
from repro.sparse import datasets as jdata
from repro.sparse import jax_apps as japps
from repro.sparse import ref as jref
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import histogram as thist
from repro_torch.kernels import moe_gmm as tgmm
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spmv as tspmv
from repro_torch.sparse import csr as tcsr
from repro_torch.sparse import datasets as tdata
from repro_torch.sparse import ref as tref
from repro_torch.sparse import torch_apps as tapps


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# histogram
# ---------------------------------------------------------------------------

# (N, bins): empty, one, and primes off the 1024-element and 256-bin tiles
HIST_SIZES = [(0, 5), (1, 1), (811, 53), (997, 61), (4099, 257),
              (2048, 4096)]


@pytest.mark.parametrize("n,bins", HIST_SIZES)
def test_plain_histogram_matches_pallas(n, bins):
    """Equal to ``histogram_pallas`` (interpret) with -1 padding and ids
    past the last bin present: neither counts them."""
    rng = np.random.default_rng(n + bins)
    ids = rng.integers(0, bins + 9, n).astype(np.int32)
    ids[rng.random(n) < 0.1] = -1
    got = thist.plain_histogram(_t(ids), bins).numpy()
    want = np.asarray(histogram_pallas(jnp.asarray(ids), bins))
    assert got.dtype == np.int32 and np.array_equal(got, want)
    inb = ids[(ids >= 0) & (ids < bins)]
    assert np.array_equal(np.asarray(jkref.histogram_ref(
        jnp.asarray(inb), bins)), got)


def test_histogram_wrapper_takes_plain_version_on_cpu():
    ids = _t(np.array([3, -1, 0, 7, 3, 2], np.int32))
    thist.reset_launches()
    assert tops.histogram(ids, 4).tolist() == [1, 0, 1, 2]
    assert tops.histogram(ids[:0], 3).tolist() == [0, 0, 0]
    assert thist.LAUNCHES == {"histogram": 0}
    with pytest.raises(ValueError, match="n_bins"):
        tops.histogram(ids, 0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.histogram(ids.to("meta"), 4)


# ---------------------------------------------------------------------------
# BSR SpMV
# ---------------------------------------------------------------------------

BSR_CASES = [(4, 3, 32, 6), (8, 2, 64, 8), (2, 5, 128, 4), (3, 4, 16, 5)]


def _bsr_inputs(seed, r, kb, bs, ncb):
    rng = np.random.default_rng(seed)
    bc = rng.integers(0, ncb, (r, kb)).astype(np.int32)
    blocks = rng.random((r, kb, bs, bs)).astype(np.float32)
    x = rng.random(ncb * bs).astype(np.float32)
    return bc, blocks, x


def _bsr_row_scale(bc, blocks, x):
    """Per output row: sum over its terms of |a * x| (float64)."""
    bs = blocks.shape[-1]
    gathered = x.reshape(-1, bs)[bc].astype(np.float64)
    return np.einsum("rkij,rkj->ri", np.abs(blocks.astype(np.float64)),
                     np.abs(gathered)).reshape(-1)


@pytest.mark.parametrize("r,kb,bs,ncb", BSR_CASES)
def test_plain_bsr_spmv_matches_pallas(r, kb, bs, ncb):
    """Two float32 sums of the same ``Kb * BS`` products in other orders
    differ by at most ``2 * Kb * BS * 2^-24`` of the row's sum of
    |a * x|: the tolerance, row by row, against the Pallas kernel
    (interpret) and the einsum oracle."""
    bc, blocks, x = _bsr_inputs(r * 7 + bs, r, kb, bs, ncb)
    got = tspmv.plain_bsr_spmv(_t(bc), _t(blocks), _t(x)).numpy()
    tol = 2 * kb * bs * 2.0 ** -24 * _bsr_row_scale(bc, blocks, x)
    for want in (bsr_spmv_pallas(jnp.asarray(bc), jnp.asarray(blocks),
                                 jnp.asarray(x)),
                 jkref.bsr_spmv_ref(jnp.asarray(bc), jnp.asarray(blocks),
                                    jnp.asarray(x))):
        want = np.asarray(want)
        assert got.shape == want.shape == (r * bs,)
        assert np.all(np.abs(got - want) <= tol)


def test_bsr_wrapper_takes_plain_version_on_cpu():
    bc, blocks, x = _bsr_inputs(3, 2, 2, 8, 3)
    tspmv.reset_launches()
    assert torch.equal(tops.bsr_spmv(_t(bc), _t(blocks), _t(x)),
                       tspmv.plain_bsr_spmv(_t(bc), _t(blocks), _t(x)))
    assert tspmv.LAUNCHES == {"bsr_spmv": 0}
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.bsr_spmv(_t(bc).to("meta"), _t(blocks).to("meta"),
                      _t(x).to("meta"))


GRAPHS = {"rmat9": ("rmat", dict(scale=9, edge_factor=8, seed=2)),
          "er256": ("erdos_renyi", dict(n=256, avg_degree=8, seed=5)),
          "wl300": ("wiki_like", dict(n_vertices=300, avg_degree=6, seed=7))}


def _graphs(name):
    fn, kw = GRAPHS[name]
    return getattr(jdata, fn)(**kw), getattr(tdata, fn)(**kw)


@pytest.mark.parametrize("gname,bs", [("rmat9", 64), ("rmat9", 128),
                                      ("er256", 32), ("wl300", 16),
                                      ("wl300", 128)])
def test_csr_to_bsr_byte_identical(gname, bs):
    jg, tg = _graphs(gname)
    jbc, jblocks = j_csr_to_bsr(jg, bs)
    bc, blocks = tops.csr_to_bsr(tg, bs)
    for got, want in ((bc, jbc), (blocks, jblocks)):
        want = np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()


def test_csr_to_bsr_empty_graph():
    g = tcsr.from_edges(5, np.zeros(0, np.int64), np.zeros(0, np.int64))
    bc, blocks = tops.csr_to_bsr(g, 4)
    assert bc.shape == (2, 1) and blocks.shape == (2, 1, 4, 4)
    assert not bc.any() and not blocks.any()


@pytest.mark.parametrize("gname,bs", [("rmat9", 64), ("er256", 32)])
def test_spmv_csr_matches_reference(gname, bs):
    """The port's ``spmv_csr`` (plain BSR on the CPU) against the
    reference's (Pallas interpret) within the BSR tolerance, and against
    the float64 graph oracle as ``tests/test_kernels.py`` holds it."""
    jg, tg = _graphs(gname)
    x = np.random.default_rng(1).random(tg.n)
    got = tops.spmv_csr(tg, x, bs=bs, device="cpu")
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    got = got.numpy()
    want = np.asarray(j_spmv_csr(jg, x, bs=bs))
    bc, blocks = tops.csr_to_bsr(tg, bs)
    xp = np.zeros(bc.shape[0] * bs, np.float32)
    xp[:tg.n] = x
    kb = bc.shape[1]
    tol = 2 * kb * bs * 2.0 ** -24 * _bsr_row_scale(bc, blocks, xp)[:tg.n]
    assert np.all(np.abs(got - want) <= tol)
    assert np.allclose(got, tref.spmv_ref(tg, x), rtol=1e-4, atol=1e-2)


def test_spmv_csr_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = _graphs("er256")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tops.spmv_csr(tg, np.ones(tg.n))


# ---------------------------------------------------------------------------
# host side: histogram_data and the oracles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(n=1 << 12, n_bins=64, seed=4),
                                dict(n=1 << 11, n_bins=64, seed=4),
                                dict(n=997, n_bins=61, seed=0),
                                dict(n=0, n_bins=8, seed=1)])
def test_histogram_data_byte_identical(kw):
    got, want = tdata.histogram_data(**kw), jdata.histogram_data(**kw)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("gname", list(GRAPHS))
def test_stream_and_add_oracles_match_reference(gname):
    jg, tg = _graphs(gname)
    x = np.random.default_rng(0).random(tg.n)
    assert np.array_equal(tref.spmv_ref(tg, x), jref.spmv_ref(jg, x))
    assert np.array_equal(tref.pagerank_ref(tg), jref.pagerank_ref(jg))
    assert np.array_equal(tref.pagerank_ref(tg, 0.5, 3),
                          jref.pagerank_ref(jg, 0.5, 3))
    for k in (4, 8, 12):
        assert np.array_equal(tref.kcore_ref(tg, k), jref.kcore_ref(jg, k))
    els = tdata.histogram_data(1 << 10, 32, seed=2)
    assert np.array_equal(tref.histogram_ref(els, 32),
                          jref.histogram_ref(els, 32))


@pytest.mark.parametrize("gname,n_dev,seed", [("rmat9", 8, 0), ("er256", 3, 2),
                                             ("wl300", 1, 5)])
def test_task_streams_byte_identical(gname, n_dev, seed):
    """The host-built (dest, value) streams the stream apps route."""
    jg, tg = _graphs(gname)
    x = np.random.default_rng(seed).random(tg.n)
    got = tapps.spmv_task_stream(tg, x, n_dev, seed)
    want = japps.spmv_task_stream(jg, x, n_dev, seed)
    els = tdata.histogram_data(1001, 37, seed=seed)
    got += tapps.histogram_task_stream(els, n_dev)
    want += japps.histogram_task_stream(els, n_dev)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# grouped matmul
# ---------------------------------------------------------------------------

# (T, D, F, E, rt): tests/test_kernels.py's shapes
GMM_CASES = [(256, 64, 128, 2, 128), (512, 32, 256, 4, 128),
             (384, 128, 128, 3, 128)]


def _gmm_inputs(seed, t, d, f, e, rt):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = rng.standard_normal((e, d, f)).astype(np.float32)
    gids = rng.integers(0, e, t // rt).astype(np.int32)
    return x, w, gids


@pytest.mark.parametrize("t,d,f,e,rt", GMM_CASES)
def test_plain_gmm_matches_pallas(t, d, f, e, rt):
    """|Δ| < 1e-4 against ``gmm_pallas`` (interpret) and ``gmm_ref``, the
    bound of ``tests/test_kernels.py`` (float32 sums of the same D
    products in another order); the wrapper takes the plain version."""
    x, w, gids = _gmm_inputs(t + e, t, d, f, e, rt)
    got = tgmm.plain_gmm(_t(x), _t(w), _t(gids), rt)
    assert got.dtype == torch.float32 and got.shape == (t, f)
    for want in (gmm_pallas(jnp.asarray(x), jnp.asarray(w),
                            jnp.asarray(gids), rt=rt),
                 jkref.gmm_ref(jnp.asarray(x), jnp.asarray(w),
                               jnp.asarray(gids))):
        assert np.max(np.abs(got.numpy() - np.asarray(want))) < 1e-4
    assert torch.equal(tops.gmm(_t(x), _t(w), _t(gids), rt=rt), got)


def test_plain_gmm_bf16_matches_pallas():
    """bf16 x and w, rt = 64: both sides sum the same exact float32
    products (a bf16 product fits in float32) in another order and round
    to bf16, so they may land on neighbouring bf16 values: within one
    bf16 ulp (2^-7 of the value) plus the float32 sums' 2*D*2^-24 of
    sum |x*w|."""
    t, d, f, e, rt = 256, 64, 128, 3, 64
    x, w, gids = _gmm_inputs(7, t, d, f, e, rt)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(gmm_pallas(xb, wb, jnp.asarray(gids), rt=rt)
                      .astype(jnp.float32))
    got = tgmm.plain_gmm(_t(x).bfloat16(), _t(w).bfloat16(), _t(gids), rt)
    assert got.dtype == torch.bfloat16
    xf = np.asarray(xb.astype(jnp.float32), np.float64)
    wf = np.asarray(wb.astype(jnp.float32), np.float64)
    scale = np.concatenate([np.abs(xf[i * rt:(i + 1) * rt]) @ np.abs(wf[g])
                            for i, g in enumerate(gids)])
    tol = 2.0 ** -7 * np.abs(want) + 2 * d * 2.0 ** -24 * scale
    assert np.all(np.abs(got.float().numpy() - want) <= tol)


def test_gmm_wrapper_contract_on_cpu():
    """The reference's tile contract: F split into ``ft`` tiles, T into
    ``rt`` tiles, one group id a row tile; no launch on the CPU."""
    x, w, gids = _gmm_inputs(3, 256, 16, 192, 2, 128)
    tgmm.reset_launches()
    with pytest.raises(ValueError, match="column tiles"):
        tops.gmm(_t(x), _t(w), _t(gids))             # F = 192, ft = 128
    out = tops.gmm(_t(x), _t(w), _t(gids), ft=64)
    assert out.shape == (256, 192)
    with pytest.raises(ValueError, match="group_ids"):
        tops.gmm(_t(x), _t(w[..., :128]), _t(gids[:1]))
    with pytest.raises(ValueError, match="row tiles"):
        tops.gmm(_t(x[:200]), _t(w[..., :128]), _t(gids))
    with pytest.raises(ValueError, match="group ids must lie"):
        tops.gmm(_t(x), _t(w[..., :128]), _t(gids + 2))
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.gmm(_t(x).to("meta"), _t(w[..., :128]).to("meta"),
                 _t(gids).to("meta"))
    assert tgmm.LAUNCHES == {"gmm": 0}


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

# (S, hd, tq, tk, dtype): tests/test_kernels.py's cases
FLASH_CASES = [(128, 64, 64, 64, "float32"), (256, 64, 128, 64, "float32"),
               (256, 128, 64, 128, "float32"), (128, 64, 64, 64, "bfloat16")]


def _qkv(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    return ([_t(a).to(getattr(torch, dtype)) for a in arrs],
            [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs])


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,hd,tq,tk,dtype", FLASH_CASES)
def test_plain_flash_attention_matches_pallas(s, hd, tq, tk, dtype, causal):
    """The plain online softmax with the Pallas kernel's key tile against
    ``flash_attention_pallas`` (interpret), and the wrapper (64-row
    tiles, as the CUDA kernel) against ``flash_attention_ref``: the
    bounds of ``tests/test_kernels.py``, 1e-5 in float32 (sums in another
    order) and 2e-2 in bf16 (p and the output round to bf16)."""
    b, h = 2, 2
    (tq_, tk_, tv_), (jq_, jk_, jv_) = _qkv(s + hd + tq, (b * h, s, hd),
                                            dtype)
    tol = 2e-2 if dtype == "bfloat16" else 1e-5
    want = np.asarray(flash_attention_pallas(jq_, jk_, jv_, causal=causal,
                                             tq=tq, tk=tk).astype(jnp.float32))
    got = tflash.plain_flash_attention(tq_, tk_, tv_, causal, tk=tk)
    assert got.dtype == tq_.dtype and got.shape == (b * h, s, hd)
    assert np.max(np.abs(got.float().numpy() - want)) < tol

    def four(a):
        return a.reshape(b, h, s, hd)
    want = np.asarray(jkref.flash_attention_ref(
        four(jq_), four(jk_), four(jv_), causal=causal).astype(jnp.float32))
    got = tops.flash_attention(four(tq_), four(tk_), four(tv_), causal)
    assert got.shape == (b, h, s, hd)
    assert np.max(np.abs(got.float().numpy() - want)) < tol


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flash_attention_constant_v(seed):
    """Attention of a constant V is that constant (rows of the softmax sum
    to one), as ``tests/test_kernels.py`` checks the Pallas kernel."""
    rng = np.random.default_rng(seed)
    q = _t(rng.standard_normal((1, 1, 128, 64)).astype(np.float32))
    k = _t(rng.standard_normal((1, 1, 128, 64)).astype(np.float32))
    out = tops.flash_attention(q, k, torch.ones(1, 1, 128, 64), causal=True)
    assert torch.allclose(out, torch.ones_like(out), atol=1e-5)


def test_flash_wrapper_contract_on_cpu():
    """Any S (a ragged last key tile) on the CPU, equal to the einsum
    oracle; mismatched shapes and other devices raise; no launch."""
    (q, k, v), (jq_, jk_, jv_) = _qkv(5, (1, 3, 100, 16), "float32")
    tflash.reset_launches()
    got = tops.flash_attention(q, k, v, causal=True)
    want = np.asarray(jkref.flash_attention_ref(jq_, jk_, jv_, causal=True))
    assert np.max(np.abs(got.numpy() - want)) < 1e-5
    with pytest.raises(ValueError, match="alike"):
        tflash.flash_attention(q[0], k[0, :, :50], v[0])
    with pytest.raises(ValueError, match=r"\[B, H, S, hd\]"):
        tops.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError, match="cuda or cpu"):
        tops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert tflash.LAUNCHES == {"flash_attention": 0}

