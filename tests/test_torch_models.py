"""The port's decoder LMs against the JAX package, on the CPU.

The reference runs in process on the JAX CPU backend; its
``DecoderLM.init`` parameters are carried across as numpy
(``model_zoo.params_from_numpy``). Held to the reference:

* the numerics helpers (norms, cross-entropy, RoPE, M-RoPE with reduced
  head dims) at 1e-6;
* ``_direct_attend`` / ``_chunked_attend`` (chunk 64, window 0 and 32,
  GQA 4/2) and the kernel glue (``flash_attend``: ``plain_flash_attention``
  after the GQA expansion) at 1e-5; ``_cache_positions`` exactly, as a
  property; the cross-attention branches at 1e-5;
* ``DecoderLM.forward`` logits and ``loss`` of the 7 reduced decoder
  configs within 1e-4 of max|logit| (qwen2-vl on ``synth_batch``'s
  patches and M-RoPE positions); the SWA ring decode past its wrap within
  1e-3 of the forward, as the reference's own test; ``serve``'s greedy
  ids equal; reduced OLMoE through ``moe_dcra`` on a CPU fabric;
* ``synth_batch`` array for array, and the configs' dimensions.

The tests that need no reference, and those on the card, are in
``tests/test_torch_lm.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.configs import ARCH_IDS as J_ARCH_IDS
from repro.configs import all_configs as j_all_configs
from repro.configs import get_config as j_get_config
from repro.configs import base as jbase
from repro.data import pipeline as jpipe
from repro.launch.serve import serve as j_serve
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import transformer as jtrans
from repro.models.model_zoo import build_model as j_build_model
from repro_torch.configs import (PORTED, SHAPES, ShapeConfig, all_configs,
                                 get_config)
from repro_torch.core import dispatch as tdispatch
from repro_torch.core.dispatch import MeshInfo
from repro_torch.core.fabric import Fabric
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import flash_attention as tflash
from repro_torch.launch.serve import serve
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import transformer as ttrans
from repro_torch.models.transformer import ParamTree
from repro_torch.models.model_zoo import build_model, params_from_numpy

DECODERS = ["granite-8b", "h2o-danube-3-4b", "internlm2-1.8b", "qwen2-1.5b",
            "qwen2-vl-7b", "mixtral-8x22b", "olmoe-1b-7b"]
#: logits of the port within this share of max|logit| of the reference's
LOGIT_REL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol, err


def _models(arch, factor=None):
    """The reduced config's reference model and its params, and the port's
    model on the CPU with those params; ``factor`` sets the MoE capacity
    factor of both."""
    def cfg(get):
        c = get(arch).reduced()
        if factor is None:
            return c
        return dataclasses.replace(c, moe=dataclasses.replace(
            c.moe, capacity_factor=factor))
    jm = j_build_model(cfg(j_get_config))
    params = jm.init(jax.random.key(0))
    tm = params_from_numpy(build_model(cfg(get_config), device="cpu"),
                           jax.tree.map(np.asarray, params))
    return jm, params, tm


def _scale(a):
    return float(np.abs(np.asarray(a, np.float64)).max())


# ---------------------------------------------------------------------------
# numerics helpers
# ---------------------------------------------------------------------------

def test_norms_and_cross_entropy_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (2, 5, 48)).astype(np.float32)
    g = rng.normal(1, 0.1, 48).astype(np.float32)
    b = rng.normal(0, 0.1, 48).astype(np.float32)
    want = jcommon.rms_norm(jnp.asarray(x), jnp.asarray(g))
    _close(tcommon.rms_norm(_t(x), _t(g)), want, 1e-6 * _scale(want))
    want = jcommon.layer_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    _close(tcommon.layer_norm(_t(x), _t(g), _t(b)), want,
           1e-6 * _scale(want))
    logits = rng.normal(0, 4, (3, 7, 300)).astype(np.float32)
    labels = rng.integers(0, 300, (3, 7)).astype(np.int32)
    want = jcommon.softmax_cross_entropy(jnp.asarray(logits),
                                         jnp.asarray(labels))
    _close(tcommon.softmax_cross_entropy(_t(logits), _t(labels)), want,
           1e-6 * _scale(want))
    # bf16 input: float32 reduction, cast back before the gamma multiply
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = tcommon.rms_norm(xb, _t(g).to(torch.bfloat16))
    want = jcommon.rms_norm(jnp.asarray(x, jnp.bfloat16),
                            jnp.asarray(g, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    assert np.array_equal(got.float().numpy(),
                          np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("hd", [16, 32, 120, 128])
def test_rope_and_mrope_match_reference(hd):
    """Split-halves RoPE, and M-RoPE with its sections rescaled where the
    head dim is reduced (hd 16, 32, 120) and as published (128), within
    1e-6 of max|out|. ``theta ** (i / half)`` may round one ulp apart in
    the two libraries (hd 120 at theta 1e4 has one such frequency): the
    frequencies are held to one ulp, and the angle ``pos * freq`` that a
    one-ulp frequency moves by ``pos * dfreq`` widens the bound by
    ``2 max|x| max(pos * dfreq)``."""
    rng = np.random.default_rng(hd)
    B, S, H = 2, 9, 3
    x = rng.normal(0, 1, (B, S, H, hd)).astype(np.float32)
    pos = rng.integers(0, 4096, (B, S)).astype(np.int32)

    def tol(want, theta, pmax):
        f_j = np.asarray(jcommon.rope_freqs(hd, theta))
        d_f = np.abs(tcommon.rope_freqs(hd, theta).numpy() - f_j)
        assert np.all(d_f <= np.spacing(f_j))
        return 1e-6 * _scale(want) + 2 * _scale(x) * pmax * d_f.max()
    for theta in (1e4, 1e6):
        want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
        _close(tcommon.apply_rope(_t(x), _t(pos), theta), want,
               tol(want, theta, pos.max()))
    pos3 = rng.integers(0, 300, (B, 3, S)).astype(np.int32)
    for theta in (1e4, 1e6):
        want = jcommon.apply_mrope(jnp.asarray(x), jnp.asarray(pos3), theta)
        _close(tcommon.apply_mrope(_t(x), _t(pos3), theta), want,
               tol(want, theta, pos3.max()))


def test_no_logical_sharding_annotations():
    """A deliberate difference: the port has no ``shard`` /
    ``logical_axis_rules``. With no rules installed (one card: no mesh to
    map logical axes onto) the reference's annotation is the identity,
    which is what the port computes."""
    assert not hasattr(tcommon, "shard")
    assert not hasattr(tcommon, "logical_axis_rules")
    x = jnp.arange(6.0).reshape(2, 3)
    assert jcommon.shard(x, "act_batch", "act_embed") is x


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _qkv(seed, B=1, S=256, Hq=4, Hkv=2, hd=16):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (B, S, h, hd)).astype(np.float32)
            for h in (Hq, Hkv, Hkv)]


@pytest.mark.parametrize("window", [0, 32])
def test_direct_and_chunked_attend_match_reference(window):
    """GQA 4/2, chunk 64 (the last chunk ragged at S 250), window 0 and
    32: the port's two torch paths against the reference's two."""
    q, k, v = _qkv(window, S=250)
    pos = np.arange(250, dtype=np.int32)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(_t, (q, k, v))
    want = jattn._direct_attend(jq, jk, jv, jnp.asarray(pos)[None],
                                jnp.asarray(pos), True, window)
    _close(tattn._direct_attend(tq, tk, tv, _t(pos)[None], _t(pos), True,
                                window), want, 1e-5)
    want_c = jattn._chunked_attend(jq, jk, jv, jnp.asarray(pos)[None],
                                   jnp.asarray(pos), True, window, chunk=64)
    _close(tattn._chunked_attend(tq, tk, tv, _t(pos)[None], _t(pos), True,
                                 window, chunk=64), want_c, 1e-5)


def test_kernel_glue_matches_reference_direct_attend():
    """``flash_attend`` (GQA expanded so head h reads KV head h // G, then
    ``ops.flash_attention``'s plain version on the CPU) against the
    reference's ``_direct_attend`` with index positions, causal and not;
    a wrong grouping (h % Hkv) is far off."""
    q, k, v = _qkv(3, B=2, S=100, Hq=6, Hkv=2)
    pos = np.arange(100, dtype=np.int32)
    for causal in (True, False):
        want = np.asarray(jattn._direct_attend(
            *map(jnp.asarray, (q, k, v)), jnp.asarray(pos)[None],
            jnp.asarray(pos), causal, 0))
        tflash.reset_launches()
        got = tattn.flash_attend(_t(q), _t(k), _t(v), causal)
        assert tflash.LAUNCHES["flash_attention"] == 0   # plain on the CPU
        _close(got, want, 1e-5)
        wrong = tattn.flash_attend(_t(q), _t(np.tile(k, (1, 1, 3, 1))),
                                   _t(np.tile(v, (1, 1, 3, 1))), causal)
        assert np.abs(wrong.numpy() - want).max() > 1e-2


@settings(max_examples=25, deadline=None)
@given(pos=st.integers(0, 300), cap=st.sampled_from([1, 16, 32, 64]))
def test_cache_positions_match_reference(pos, cap):
    want = np.asarray(jattn._cache_positions(jnp.array(pos, jnp.int32), cap))
    got = tattn._cache_positions(pos, cap)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_scatter_slot_is_the_one_hot_blend():
    """The ring write is the reference's blend, so a non-finite entry
    anywhere in the cache turns NaN in both (not an index copy)."""
    rng = np.random.default_rng(5)
    cache = rng.normal(0, 1, (2, 8, 2, 4)).astype(np.float32)
    cache[0, 3, 1, 2] = np.inf
    kv = rng.normal(0, 1, (2, 1, 2, 4)).astype(np.float32)
    for slot in (0, 3, 7):
        want = np.asarray(jattn._scatter_slot(jnp.asarray(cache),
                                              jnp.asarray(kv), slot))
        got = tattn._scatter_slot(_t(cache), _t(kv), slot).numpy()
        assert np.array_equal(np.isnan(got), np.isnan(want))
        fin = ~np.isnan(want)
        assert np.array_equal(got[fin], want[fin])


def test_cross_attention_branches_match_reference():
    """``kv_source`` (train) and ``kv_precomputed`` through
    ``project_cross_kv`` (decode), with QKV bias, GQA 4/2."""
    cfg_j = j_get_config("qwen2-1.5b").reduced()
    cfg_t = get_config("qwen2-1.5b").reduced()
    params = jattn.init_attention(jax.random.key(3), cfg_j)
    rng = np.random.default_rng(6)
    params = {k: np.asarray(v) + (rng.normal(0, 0.1, v.shape).astype(
        np.float32) if k.startswith("b") else 0) for k, v in params.items()}
    tparams = {k: _t(v) for k, v in params.items()}
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    x = rng.normal(0, 1, (2, 5, cfg_t.d_model)).astype(np.float32)
    enc = rng.normal(0, 1, (2, 11, cfg_t.d_model)).astype(np.float32)
    pos = np.tile(np.arange(5, dtype=np.int32), (2, 1))
    want, _ = jattn.attention_block(jparams, jnp.asarray(x), cfg_j,
                                    jnp.asarray(pos), causal=False,
                                    kv_source=jnp.asarray(enc))
    got, _ = tattn.attention_block(tparams, _t(x), cfg_t, _t(pos),
                                   causal=False, kv_source=_t(enc))
    _close(got, want, 1e-5)
    jkv = jattn.project_cross_kv(jparams, jnp.asarray(enc), cfg_j)
    tkv = tattn.project_cross_kv(tparams, _t(enc), cfg_t)
    for a, b in zip(tkv, jkv):
        _close(a, b, 1e-5)
    want, _ = jattn.attention_block(jparams, jnp.asarray(x), cfg_j,
                                    jnp.asarray(pos), kv_precomputed=jkv)
    got, _ = tattn.attention_block(tparams, _t(x), cfg_t, _t(pos),
                                   kv_precomputed=tkv)
    _close(got, want, 1e-5)


def test_decoder_block_cross_attention_matches_reference():
    """A block with cross-attention (the encoder-decoder's, item 5b's
    first user): ``enc_out`` (train) and one decode step over
    ``enc_kv``, against the reference's ``decoder_block`` at 1e-5."""
    cfg_j = j_get_config("internlm2-1.8b").reduced()
    cfg_t = get_config("internlm2-1.8b").reduced()
    params = jax.tree.map(np.array, jtrans.init_decoder_block(
        jax.random.key(5), cfg_j, cross=True))
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = ParamTree(jax.tree.map(_t, params))
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 6, cfg_t.d_model)).astype(np.float32)
    enc = rng.normal(0, 1, (2, 9, cfg_t.d_model)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32), (2, 1))
    want, _, _ = jtrans.decoder_block(jparams, jnp.asarray(x), cfg_j,
                                      jnp.asarray(pos),
                                      enc_out=jnp.asarray(enc))
    got, _, _ = ttrans.decoder_block(tparams, _t(x), cfg_t, _t(pos),
                                     enc_out=_t(enc), index_positions=True)
    _close(got, want, 1e-5 * _scale(want))
    jkv = jattn.project_cross_kv(jparams["xattn"], jnp.asarray(enc), cfg_j)
    tkv = tattn.project_cross_kv(tparams["xattn"], _t(enc), cfg_t)
    jcache = jattn.init_kv_cache(cfg_j, 2, 4, jnp.float32)
    tcache = tattn.init_kv_cache(cfg_t, 2, 4, torch.float32)
    want, jc, _ = jtrans.decoder_block(
        jparams, jnp.asarray(x[:, :1]), cfg_j, jnp.asarray(pos[:, :1]),
        cache=jcache, cache_pos=jnp.array(0, jnp.int32), enc_kv=jkv)
    got, tc, _ = ttrans.decoder_block(
        tparams, _t(x[:, :1]), cfg_t, _t(pos[:, :1]), cache=tcache,
        cache_pos=0, enc_kv=tkv)
    _close(got, want, 1e-5 * _scale(want))
    _close(tc.k, jc.k, 1e-5 * _scale(jc.k))
    assert tc.length == int(jc.length) == 1


# ---------------------------------------------------------------------------
# the decoder LMs
# ---------------------------------------------------------------------------

def _batch(cfg, B=2, S=64, step=0):
    return tpipe.synth_batch(cfg, ShapeConfig("t", S, B, "train"), step)


@pytest.mark.parametrize("arch", DECODERS)
def test_forward_and_loss_match_reference(arch):
    """Reduced config, the reference's weights: logits within 1e-4 of
    max|logit|, the loss and its parts within 1e-5 relative; the kernel
    glue where the mask allows and the torch path (``kernel=False``)
    agree within 1e-5 of max|logit|."""
    jm, params, tm = _models(arch)
    batch = _batch(tm.cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    want, want_aux = jm.forward(params, jbatch)
    want = np.asarray(want)
    got, aux = tm.forward(batch)
    scale = _scale(want)
    _close(got, want, LOGIT_REL * scale)
    _close(aux, want_aux, 1e-5 * max(1.0, abs(float(want_aux))))
    plain, _ = tm.forward(batch, kernel=False)
    _close(plain, got.numpy(), 1e-5 * scale)
    total, parts = tm.loss(batch)
    jtotal, jparts = jm.loss(params, jbatch)
    for key in ("loss", "ce", "aux"):
        _close(parts[key], jparts[key], 1e-5 * max(1.0, abs(float(
            jparts[key]))))
    assert float(total) == float(parts["loss"])


@pytest.mark.parametrize("arch,seq,calls", [
    ("granite-8b", 64, 2),          # causal over indices: the glue
    ("qwen2-vl-7b", 64, 0),         # positions from the batch
    ("h2o-danube-3-4b", 64, 0),     # SWA window 16 < S
    ("h2o-danube-3-4b", 16, 2),     # S <= window: the mask is causal
    ("olmoe-1b-7b", 32, 2)])
def test_attention_takes_the_kernel_where_its_mask_is_the_layers(
        arch, seq, calls, monkeypatch):
    """A deliberate difference: the port's forward runs each layer's
    attention through the flash kernel's glue exactly where the kernel's
    mask is the layer's (on the CPU its plain version, counted here), and
    through the torch ``attend`` elsewhere; never on decode."""
    _, _, tm = _models(arch)
    seen = []
    plain = tflash.plain_flash_attention
    monkeypatch.setattr(tflash, "plain_flash_attention",
                        lambda *a, **k: seen.append(1) or plain(*a, **k))
    tm.forward(_batch(tm.cfg, S=seq))
    assert len(seen) == calls
    cache = tm.init_cache(2, 4, torch.float32)
    tm.decode_step(cache, torch.zeros((2, 1), dtype=torch.int32), 0)
    assert len(seen) == calls
    tm.forward(_batch(tm.cfg, S=seq), kernel=False)
    assert len(seen) == calls


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "mixtral-8x22b"])
def test_swa_decode_matches_forward(arch):
    """SWA ring buffer: teacher-forced decode equals the full forward past
    the window's wrap, within 1e-3 (the reference's bound); the forward
    is the reference's within 1e-4 of max|logit|. MoE at factor 8 (no
    drop either way)."""
    moe = get_config(arch).moe is not None
    jm, params, tm = _models(arch, factor=8.0 if moe else None)
    assert tm.cfg.sliding_window > 0
    B, S = 1, tm.cfg.sliding_window * 2 + 8
    tok = np.random.default_rng(1).integers(0, tm.cfg.vocab_size,
                                            (B, S)).astype(np.int32)
    logits, _ = tm.forward({"tokens": tok})
    want, _ = jm.forward(params, {"tokens": jnp.asarray(tok)})
    _close(logits, want, LOGIT_REL * _scale(want))
    cache = tm.init_cache(B, S, torch.float32)
    assert cache[0].k.shape[1] == tm.cfg.sliding_window
    outs = []
    for t in range(S):
        lg, cache = tm.decode_step(cache, _t(tok[:, t:t + 1]), t)
        outs.append(lg)
    assert cache[0].length == S
    _close(torch.cat(outs, 1), logits.numpy(), 1e-3)


@pytest.mark.parametrize("arch", ["granite-8b", "qwen2-1.5b"])
def test_serve_matches_reference(arch):
    """Greedy ids of ``launch/serve.py::serve`` equal the reference's on
    the same weights and prompts; ``gen`` 0 gives ``[B, 0]`` int32."""
    jm, params, tm = _models(arch)
    prompts = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (3, 6)).astype(np.int32)
    want = np.asarray(j_serve(jm.cfg, jm, params, jnp.asarray(prompts), 7))
    got = serve(tm.cfg, tm, _t(prompts), 7)
    assert got.dtype == torch.int32 and got.shape == (3, 7)
    assert np.array_equal(got.numpy(), want)
    assert tuple(serve(tm.cfg, tm, _t(prompts), 0).shape) == (3, 0)


def test_bf16_decode_over_a_float32_cache_matches_reference():
    """``serve`` keeps a float32 cache whatever the model's type: a bf16
    model's attention then meets bf16 q and float32 K/V, and the
    reference's einsums promote (so does the residual stream after it).
    Logits of the type the reference gives, within 2^-6 of max|logit|
    (bf16 roundings of layer 0 in two libraries)."""
    jm, params, tm = _models("qwen2-1.5b")
    jb = j_build_model(jm.cfg, dtype=jnp.bfloat16)
    tb = build_model(tm.cfg, dtype=torch.bfloat16, device="cpu")
    tb.load(tm.tree())
    tok = np.random.default_rng(4).integers(0, tm.cfg.vocab_size,
                                            (2, 3)).astype(np.int32)
    jcache = jb.init_cache(2, 3, jnp.float32)
    tcache = tb.init_cache(2, 3, torch.float32)
    for t in range(3):
        want, jcache = jb.decode_step(params, jcache,
                                      jnp.asarray(tok[:, t:t + 1]),
                                      jnp.array(t, jnp.int32))
        got, tcache = tb.decode_step(tcache, _t(tok[:, t:t + 1]), t)
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        _close(got, want.astype(jnp.float32), 2.0 ** -6 * _scale(
            want.astype(jnp.float32)))
    got = serve(tb.cfg, tb, _t(tok), 2)
    assert got.shape == (2, 2)


def test_olmoe_through_moe_dcra_matches_einsum_and_reference(monkeypatch):
    """Reduced OLMoE-1B-7B with a ``MeshInfo`` over a CPU
    ``Fabric.virtual`` (data 2, expert 2, tp 1) at capacity factor 8:
    the layers run ``moe_dcra`` (no drop); the logits equal the same
    model's without a ``MeshInfo`` (the einsum MoE) and the reference's
    ``DecoderLM`` within 1e-4 of max|logit|."""
    jm, params, tm = _models("olmoe-1b-7b", factor=8.0)
    info = MeshInfo(Fabric.virtual((2, 2, 1), ("data", "expert", "tp"),
                                   device="cpu"))
    dm = build_model(tm.cfg, mesh_info=info)
    assert dm.device == torch.device("cpu")
    dm.load(tm.tree())
    batch = _batch(tm.cfg, S=32)
    want = np.asarray(jm.forward(params, {k: jnp.asarray(v)
                                          for k, v in batch.items()})[0])
    scale = _scale(want)
    drops = []
    dcra = tdispatch.moe_dcra

    def counted(*args, **kw):
        out, aux, stats = dcra(*args, return_stats=True, **kw)
        drops.append(stats.total_dropped)
        return out, aux
    monkeypatch.setattr(tdispatch, "moe_dcra", counted)
    got, aux = dm.forward(batch)
    assert drops == [0] * tm.cfg.num_layers
    einsum, _ = tm.forward(batch)
    _close(got, einsum.numpy(), LOGIT_REL * scale)
    _close(got, want, LOGIT_REL * scale)
    # the aux loss is averaged per shard here, per token group there
    assert np.isfinite(float(aux)) and float(aux) > 0


def test_params_from_numpy_keeps_paths_values_and_types():
    jm, params, tm = _models("qwen2-1.5b")
    names = dict(tm.named_parameters())
    assert "lm_head" not in names                  # tied embeddings
    assert {"embed", "ln_f", "blocks.0.attn.wq", "blocks.1.attn.bq",
            "blocks.1.mlp.wd", "blocks.0.ln2"} <= set(names)
    for path, p in names.items():
        node = params
        parts = path.split(".")
        if parts[0] == "blocks":
            node, parts = jax.tree.map(lambda a: a[int(parts[1])],
                                       params["blocks"]), parts[2:]
        for part in parts:
            node = node[part]
        ref = np.asarray(node)
        assert p.dtype == torch.float32 and not p.requires_grad
        assert np.array_equal(p.numpy(), ref), path
    with pytest.raises(ValueError, match="layers"):
        params_from_numpy(build_model(dataclasses.replace(
            tm.cfg, num_layers=3), device="cpu"),
            jax.tree.map(np.asarray, params))


# ---------------------------------------------------------------------------
# data and configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["dense", "moe", "vlm", "encdec"])
def test_synth_batch_matches_reference(family):
    arch = {"dense": "granite-8b", "moe": "mixtral-8x22b",
            "vlm": "qwen2-vl-7b", "encdec": "granite-8b"}[family]
    tcfg = dataclasses.replace(get_config(arch).reduced(), family=family)
    jcfg = dataclasses.replace(j_get_config(arch).reduced(), family=family)
    for shape, step, seed in ((("t", 64, 2, "train"), 0, 0),
                              (("p", 600, 3, "prefill"), 5, 7)):
        want = jpipe.synth_batch(jcfg, jbase.ShapeConfig(*shape), step, seed)
        got = tpipe.synth_batch(tcfg, ShapeConfig(*shape), step, seed)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k
    it_t = tpipe.batches(tcfg, ShapeConfig("t", 32, 1, "train"), 3, 1)
    it_j = jpipe.batches(jcfg, jbase.ShapeConfig("t", 32, 1, "train"), 3, 1)
    for _ in range(2):
        a, b = next(it_t), next(it_j)
        assert all(np.array_equal(a[k], b[k]) for k in b)


def test_configs_and_shapes_match_reference():
    """All ten archs, full and reduced (rwkv6's ``num_heads`` 0 included:
    ``resolved_head_dim`` falls back to d_model), and ``all_configs``."""
    assert list(PORTED) == list(J_ARCH_IDS)
    assert {k: dataclasses.asdict(v) for k, v in all_configs().items()} == {
        k: dataclasses.asdict(v) for k, v in j_all_configs().items()}
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jbase.SHAPES.items()}
    for arch in J_ARCH_IDS:
        got, want = get_config(arch), j_get_config(arch)
        for a, b in ((got, want), (got.reduced(), want.reduced())):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            assert a.param_count() == b.param_count()
            assert a.active_param_count() == b.active_param_count()
            assert (a.sub_quadratic, a.attn_free, a.resolved_head_dim) == (
                b.sub_quadratic, b.attn_free, b.resolved_head_dim)
            assert [c.name for c in a.shape_cells()] == [
                c.name for c in b.shape_cells()]
    g = get_config("granite-8b")
    assert (g.num_layers, g.d_model, g.num_heads, g.num_kv_heads,
            g.resolved_head_dim, g.d_ff, g.vocab_size) == (
                36, 4096, 32, 8, 128, 14336, 49152)
    assert g.param_count() == 8_254_685_184
