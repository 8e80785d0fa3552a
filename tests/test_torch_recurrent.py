"""The port's recurrent, hybrid and encoder-decoder LMs against the JAX
package, on the CPU.

The reference runs in process on the JAX CPU backend; its ``init`` trees
are carried across as numpy (``model_zoo.params_from_numpy``), and the
recurrences get the same numpy arrays. Held to the reference:

* ``wkv_scan`` / ``wkv_chunked`` and ``ssd_scan`` / ``ssd_chunked``,
  float32, within 1e-5 of max|.|; the port's chunked forms equal to its
  own scans at the reference tests' bounds (1e-4 RWKV, 1e-3 Mamba);
* ``rwkv_block`` and ``mamba_block`` on both implementations, T = 1
  included, float32 (1e-5 of max|.|) and bf16 (``BF16_REL``): values,
  state, and the type of every output and state leaf;
* ``RWKVLM``, ``HybridLM`` (also 5 layers at period 2: two applications
  of the shared block and a remainder) and ``EncDecLM`` on the reduced
  configs: ``forward`` logits within 1e-5 of max|logit| at an S that
  takes the chunked form and one that takes the scan, the loss,
  ``decode_step`` against the reference's and against the forward,
  ``serve``'s ids, the bf16 types, the parameter counts;
* the deliberate differences: the cache layout (one entry a layer), and
  the pairwise decays masked before ``exp`` (finite gradients under a
  strong decay where the reference's turn NaN, the same forward).

Also the port's ``test_encdec_cross_attention_uses_encoder``, the flash
glue in seamless's encoder (non-causal) and zamba2's shared block, and a
checkpoint round trip of both models.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.launch.serve import serve as j_serve
from repro.models import mamba2 as jmamba
from repro.models import rwkv6 as jrwkv
from repro.models.model_zoo import build_model as j_build_model
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import flash_attention as tflash
from repro_torch.launch.serve import serve
from repro_torch.models import mamba2 as tmamba
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models.model_zoo import build_model, params_from_numpy

ARCHS = ["rwkv6-7b", "zamba2-7b", "seamless-m4t-large-v2"]
#: float32: values within this share of max|.| of the reference's
F32_REL = 1e-5
#: bf16, one block: two libraries round the bf16 stream at other points
#: (XLA may keep a fused chain in float32), a few bf16 ulps of max|.|
BF16_REL = 2.0 ** -6


def bf16_bound(cfg):
    """bf16 logits of a model, as a share of max|logit|: one bf16 ulp
    (2^-7) of the logit, and about two ulps a layer that add as a random
    walk over the L layers the stream passes (encoder layers and the
    shared block's applications included): ``2^-7 (1 + 2 sqrt(L))``, the
    bound ``chip_smoke.py``'s ``logit_bound`` holds bf16 runs to. (The
    reference's own bf16 logits lie as far from its float32 ones.)"""
    L = cfg.num_layers + cfg.encoder_layers
    if cfg.hybrid_attn_period:
        L += cfg.num_layers // cfg.hybrid_attn_period
    return 2.0 ** -7 * (1 + 2 * L ** 0.5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _dtype(a):
    return str(a.dtype).split(".")[-1]


def _held(got, want, rel, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max() if want.size else 0.0
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rel * scale, (what, err, rel * scale)


def _cfgs(arch, **replace):
    return (dataclasses.replace(j_get_config(arch).reduced(), **replace),
            dataclasses.replace(get_config(arch).reduced(), **replace))


def _models(arch, dtype=None, **replace):
    """The reduced config's reference model and params, and the port's
    model on the CPU with those params (activations of ``dtype``)."""
    jcfg, tcfg = _cfgs(arch, **replace)
    jm = j_build_model(jcfg, dtype=getattr(jnp, dtype or "float32"))
    params = jax.jit(jm.init)(jax.random.key(0))
    tm = params_from_numpy(build_model(tcfg, device="cpu",
                                       dtype=getattr(torch,
                                                     dtype or "float32")),
                           jax.tree.map(np.asarray, params))
    return jm, params, tm


def _batch(cfg, S, B=2):
    return tpipe.synth_batch(cfg, ShapeConfig("t", S, B, "train"), 0)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the recurrences
# ---------------------------------------------------------------------------

def _wkv_inputs(seed, B=2, T=128, H=2, hd=16, s0=True):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(0, 1, (B, T, H, hd)).astype(np.float32)
               for _ in range(3))
    w = (1 / (1 + np.exp(-rng.normal(0, 1, (B, T, H, hd)))) * 0.5
         + 0.45).astype(np.float32)
    u = (rng.normal(0, 1, (H, hd)) * 0.1).astype(np.float32)
    s = (rng.normal(0, 1, (B, H, hd, hd)) if s0 else np.zeros(
        (B, H, hd, hd))).astype(np.float32)
    return r, k, v, w, u, s


def _ssd_inputs(seed, B=2, T=128, H=3, P=8, N=4, h0=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, T, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(0, 1, (B, T, H)))).astype(np.float32)
    A = (-np.exp(rng.normal(0, 1, H) * 0.3)).astype(np.float32)
    Bm, Cm = (rng.normal(0, 1, (B, T, N)).astype(np.float32)
              for _ in range(2))
    h = (rng.normal(0, 1, (B, H, N, P)) if h0 else np.zeros(
        (B, H, N, P))).astype(np.float32)
    return x, dt, A, Bm, Cm, h


@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_wkv_matches_reference(impl):
    """Both WKV forms on the same arrays (a nonzero initial state),
    float32: y and the end state within 1e-5 of max|.|."""
    args = _wkv_inputs(0)
    kw = {"chunk": 32} if impl == "chunked" else {}
    want = getattr(jrwkv, f"wkv_{impl}")(*map(jnp.asarray, args), **kw)
    got = getattr(trwkv, f"wkv_{impl}")(*map(_t, args), **kw)
    for g, w, what in zip(got, want, ("y", "s")):
        assert g.dtype == torch.float32
        _held(g, w, F32_REL, what)


@pytest.mark.parametrize("impl", ["scan", "chunked"])
def test_ssd_matches_reference(impl):
    args = _ssd_inputs(1)
    kw = {"chunk": 32} if impl == "chunked" else {}
    want = getattr(jmamba, f"ssd_{impl}")(*map(jnp.asarray, args), **kw)
    got = getattr(tmamba, f"ssd_{impl}")(*map(_t, args), **kw)
    for g, w, what in zip(got, want, ("y", "h")):
        assert g.dtype == torch.float32
        _held(g, w, F32_REL, what)


def test_rwkv_chunked_equals_scan():
    """``tests/test_models.py::test_rwkv_chunked_equals_scan`` on the
    port: B 2, T 128, 2 heads of 16, zero state; max |diff| < 1e-4."""
    r, k, v, w, u, s0 = map(_t, _wkv_inputs(2, s0=False))
    y1, s1 = trwkv.wkv_scan(r, k, v, w, u, s0)
    y2, s2 = trwkv.wkv_chunked(r, k, v, w, u, s0, chunk=32)
    assert float((y1 - y2).abs().max()) < 1e-4
    assert float((s1 - s2).abs().max()) < 1e-4
    with pytest.raises(ValueError, match="chunk"):
        trwkv.wkv_chunked(r[:, :100], k[:, :100], v[:, :100], w[:, :100], u,
                          s0)


def test_mamba_chunked_equals_scan():
    """``tests/test_models.py::test_mamba_chunked_equals_scan`` on the
    port: B 2, T 128, 3 heads, P 8, N 4; max |diff| < 1e-3."""
    x, dt, A, Bm, Cm, h0 = map(_t, _ssd_inputs(3, h0=False))
    y1, h1 = tmamba.ssd_scan(x, dt, A, Bm, Cm, h0)
    y2, h2 = tmamba.ssd_chunked(x, dt, A, Bm, Cm, h0, chunk=32)
    assert float((y1 - y2).abs().max()) < 1e-3
    assert float((h1 - h2).abs().max()) < 1e-3


def test_decays_are_masked_before_exp():
    """A deliberate difference: under a strong decay (5 a step over a
    chunk of 32, so the masked pairs' log-decays pass float32's exp
    limit near 88) the reference's chunked forms have a NaN gradient
    (0 * inf through ``where(mask, exp(diff), 0)``); the port's mask
    before ``exp``, so their gradient is finite and their forward the
    reference's. Under a mild decay both gradients agree within 1e-4 of
    max|g|."""
    x, _, _, Bm, Cm, h0 = _ssd_inputs(4, B=1, T=64, H=2, P=4, N=3)
    A = -np.ones(2, np.float32)
    r, k, v, _, u, s0 = _wkv_inputs(5, B=1, T=64, H=2, hd=4)
    cases = {
        "ssd": (lambda m, lib, dt: m.ssd_chunked(
            *map(lib, (x, dt, A, Bm, Cm, h0)), chunk=32)[0].sum(),
                np.full((1, 64, 2), 5.0, np.float32),
                np.full((1, 64, 2), 0.1, np.float32)),
        "wkv": (lambda m, lib, w: m.wkv_chunked(
            *map(lib, (r, k, v, w, u, s0)), chunk=32)[0].sum(),
                np.full((1, 64, 2, 4), np.exp(-5.0), np.float32),
                np.full((1, 64, 2, 4), 0.9, np.float32))}
    for name, (f, strong, mild) in cases.items():
        jm, tm = (jmamba, tmamba) if name == "ssd" else (jrwkv, trwkv)
        for arg, nan_ref in ((strong, True), (mild, False)):
            jg = jax.jit(jax.grad(lambda a: f(jm, jnp.asarray, a)))(
                jnp.asarray(arg))
            ta = _t(arg).requires_grad_(True)
            out = f(tm, lambda a: a if a is ta else _t(a), ta)
            (tg,) = torch.autograd.grad(out, ta)
            _held(out, f(jm, jnp.asarray, jnp.asarray(arg)), F32_REL, name)
            assert bool(torch.isfinite(tg).all()), name
            assert bool(jnp.isnan(jg).any()) == nan_ref, name
            if not nan_ref:
                _held(tg, jg, 1e-4, name)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _block_case(arch, seed, T, B=2):
    """Reduced config, a block's reference params, x [B, T, D] and a
    random float32 initial state (numpy)."""
    jcfg, tcfg = _cfgs(arch)
    key = jax.random.key(seed)
    init = (jrwkv.init_rwkv_block if arch == "rwkv6-7b"
            else jmamba.init_mamba_block)
    params = jax.tree.map(np.asarray, init(key, jcfg))
    rng = np.random.default_rng(seed)
    params = {k: (v + rng.normal(0, 0.1, v.shape)).astype(np.float32)
              if k in ("u", "conv_b", "A_log") else v
              for k, v in params.items()}
    x = rng.normal(0, 1, (B, T, tcfg.d_model)).astype(np.float32)
    state0 = (jrwkv.init_rwkv_state(jcfg, B) if arch == "rwkv6-7b"
              else jmamba.init_mamba_state(jcfg, B))
    state = [rng.normal(0, 0.5, s.shape).astype(np.float32) for s in state0]
    return jcfg, tcfg, params, x, state


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T,impl", [(64, "chunked"), (64, "scan"),
                                    (40, "chunked"), (1, "chunked")])
@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b"])
def test_block_matches_reference(arch, T, impl, dtype):
    """``rwkv_block`` / ``mamba_block`` from the same params, x and
    initial state: the output and every state leaf within ``F32_REL``
    (float32) or ``BF16_REL`` (bf16) of max|.|, and of the reference's
    type (bf16 Mamba: the conv output float32, its new tail bf16, the
    SSM state float32). T 40 and 1 fall back to the scan."""
    jcfg, tcfg, params, x, state = _block_case(arch, T, T)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    if arch == "rwkv6-7b":
        jf, tf = jrwkv.rwkv_block, trwkv.rwkv_block
        jst, tst = jrwkv.RWKVState, trwkv.RWKVState
    else:
        jf, tf = jmamba.mamba_block, tmamba.mamba_block
        jst, tst = jmamba.MambaState, tmamba.MambaState
    want, wstate = jax.jit(lambda p, xs, st: jf(p, xs, jcfg, st, impl=impl))(
        {k: jnp.asarray(v) for k, v in params.items()},
        jnp.asarray(x).astype(jd), jst(*map(jnp.asarray, state)))
    got, gstate = tf({k: _t(v) for k, v in params.items()}, _t(x).to(td),
                     tcfg, tst(*map(_t, state)), impl=impl)
    rel = F32_REL if dtype == "float32" else BF16_REL
    assert _dtype(got) == str(want.dtype) == dtype
    _held(got, want, rel, "out")
    assert type(gstate).__name__ == type(wstate).__name__
    for f, g, w in zip(gstate._fields, gstate, wstate):
        assert _dtype(g) == str(w.dtype), f
        _held(g, w, rel, f)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

MODEL_CASES = [("rwkv6-7b", {}), ("zamba2-7b", {}),
               ("zamba2-7b", {"num_layers": 5}),
               ("seamless-m4t-large-v2", {})]


@pytest.mark.parametrize("S", [64, 40])
@pytest.mark.parametrize("arch,replace", MODEL_CASES)
def test_forward_and_loss_match_reference(arch, replace, S):
    """Reduced configs on the reference's weights, S 64 (the chunked
    forms: chunk 32) and 40 (the scans): logits within 1e-5 of
    max|logit|, aux and the loss's parts within 1e-5 relative; the port's
    own ``kernel=False`` forward within 1e-5 of max|logit| of its kernel
    forward. zamba2 at 5 layers, period 2: two applications of the shared
    block and a remainder segment of one layer."""
    jm, params, tm = _models(arch, **replace)
    batch = _batch(tm.cfg, S)
    # eager: the jitted reference fuses and reorders its float32 sums,
    # which moves its own logits by about 1e-5 of max|logit| here
    want, want_aux = jm.forward(params, _jbatch(batch))
    got, aux = tm.forward(batch)
    assert got.dtype == torch.float32
    _held(got, want, F32_REL, "logits")
    assert float(aux) == float(want_aux) == 0.0
    plain, _ = tm.forward(batch, kernel=False)
    _held(plain, got, F32_REL, "kernel=False")
    _, parts = tm.loss(batch)
    _, jparts = jax.jit(jm.loss)(params, _jbatch(batch))
    for key in ("loss", "ce", "aux"):
        assert abs(float(parts[key]) - float(jparts[key])) <= F32_REL * max(
            1.0, abs(float(jparts[key]))), key


def _encdec_cache(model, batch, B, S, dtype=torch.float32):
    """An ``EncDecLM`` cache whose cross K/V are the encoder's (through
    ``precompute_cross_kv``), for S decode steps."""
    cache = model.init_cache(B, S, dtype, cross_len=1)
    ks, vs = model.precompute_cross_kv(model.encode(batch["src_embeds"]))
    return {**cache, "cross_k": ks, "cross_v": vs}


@pytest.mark.parametrize("arch,replace", MODEL_CASES)
def test_decode_matches_reference_and_forward(arch, replace):
    """Teacher-forced ``decode_step`` over a float32 cache: each step's
    logits within 1e-5 of max|logit| of the reference's ``decode_step``
    (seamless over its zero cross K/V, as ``init_cache`` gives them), and
    within 1e-4 of the port's forward at that position (seamless over
    ``precompute_cross_kv`` of its encoder's output)."""
    jm, params, tm = _models(arch, **replace)
    B, S = 2, 12
    batch = _batch(tm.cfg, 2 * S)
    tok = batch["tokens"][:, :S]
    jcache = jm.init_cache(B, S, jnp.float32)
    tcache = tm.init_cache(B, S, torch.float32)
    decode = jax.jit(jm.decode_step)
    for t in range(S):
        want, jcache = decode(params, jcache, jnp.asarray(tok[:, t:t + 1]),
                              jnp.array(t, jnp.int32))
        got, tcache = tm.decode_step(tcache, _t(tok[:, t:t + 1]), t)
        _held(got, want, F32_REL, t)
    fwd_batch = {**batch, "tokens": tok, "labels": tok}
    logits, _ = tm.forward(fwd_batch)
    cache = (_encdec_cache(tm, batch, B, S) if tm.cfg.family == "encdec"
             else tm.init_cache(B, S, torch.float32))
    outs = []
    for t in range(S):
        lg, cache = tm.decode_step(cache, _t(tok[:, t:t + 1]), t)
        outs.append(lg)
    _held(torch.cat(outs, 1), logits, 1e-4, "decode vs forward")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_reference(arch):
    """Greedy ids of ``serve`` equal the reference's on the same weights
    and prompts (seamless over the zero cross K/V, as the reference's
    ``serve``, which never encodes)."""
    jm, params, tm = _models(arch)
    prompts = np.random.default_rng(2).integers(
        0, tm.cfg.vocab_size, (3, 6)).astype(np.int32)
    want = np.asarray(j_serve(jm.cfg, jm, params, jnp.asarray(prompts), 7))
    got = serve(tm.cfg, tm, _t(prompts), 7)
    assert got.dtype == torch.int32 and got.shape == (3, 7)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_forward_and_decode_match_reference_types(arch):
    """bf16 activations over the float32 weights: the forward's logits of
    the reference's type within ``BF16_REL`` of max|logit|; one decode
    step over a float32 cache, its logits and every cache leaf of the
    reference's type (zamba2: the conv tail turns bf16, the SSM state
    stays float32; RWKV: float32 state)."""
    jm, params, tm = _models(arch, dtype="bfloat16")
    batch = _batch(tm.cfg, 64)
    want, _ = jax.jit(jm.forward)(params, _jbatch(batch))
    got, _ = tm.forward(batch)
    assert _dtype(got) == str(want.dtype) == "bfloat16"
    _held(got, want, bf16_bound(tm.cfg), "logits")
    tok = batch["tokens"][:, :1]
    want, jcache = jax.jit(jm.decode_step)(
        params, jm.init_cache(2, 4, jnp.float32), jnp.asarray(tok),
        jnp.array(0, jnp.int32))
    got, tcache = tm.decode_step(tm.init_cache(2, 4, torch.float32), _t(tok),
                                 0)
    assert _dtype(got) == str(want.dtype)
    _held(got, want, BF16_REL, "decode")
    jleaves = jax.tree.leaves(jcache)
    tleaves = _cache_leaves(tcache)
    assert len(jleaves) == len(tleaves)
    for j, t in zip(jleaves, tleaves):
        # the ring's length is an int in the port, an int32 array there
        assert (_dtype(t) if isinstance(t, torch.Tensor) else "int32") == str(
            j.dtype)


def _cache_leaves(cache):
    """The first layer's leaves of a port cache in the reference's
    flattening order (mapping keys sorted, then the fields; the reference
    stacks the layers)."""
    if isinstance(cache, dict):
        return [t for k in sorted(cache) for t in _cache_leaves(cache[k])]
    return list(cache[0]) if isinstance(cache[0], tuple) else [cache[0]]


def test_cache_layout_is_one_entry_a_layer():
    """A deliberate difference: the port's caches hold one entry a layer
    (an application of zamba2's shared block) where the reference stacks
    them on a layer axis. After three decode steps each port entry equals
    the reference's slice of it."""
    for arch, replace in (("rwkv6-7b", {}), ("zamba2-7b", {"num_layers": 5}),
                          ("seamless-m4t-large-v2", {})):
        jm, params, tm = _models(arch, **replace)
        cfg = tm.cfg
        jcache = jm.init_cache(2, 4, jnp.float32)
        tcache = tm.init_cache(2, 4, torch.float32)
        tok = _batch(cfg, 8)["tokens"][:, :3]
        decode = jax.jit(jm.decode_step)
        for t in range(3):
            _, jcache = decode(params, jcache, jnp.asarray(tok[:, t:t + 1]),
                               jnp.array(t, jnp.int32))
            _, tcache = tm.decode_step(tcache, _t(tok[:, t:t + 1]), t)
        if arch == "rwkv6-7b":
            pairs = [(tcache, jcache)]
            assert len(tcache) == cfg.num_layers
            assert isinstance(tcache[0], trwkv.RWKVState)
        elif arch == "zamba2-7b":
            assert sorted(tcache) == ["kv", "mamba"]
            assert len(tcache["mamba"]) == 5 and len(tcache["kv"]) == 2
            assert isinstance(tcache["mamba"][0], tmamba.MambaState)
            pairs = [(tcache["mamba"], jcache["mamba"]),
                     (tcache["kv"], jcache["kv"])]
        else:
            assert sorted(tcache) == ["cross_k", "cross_v", "kv"]
            L = cfg.num_layers
            assert len(tcache["kv"]) == len(tcache["cross_k"]) == L
            assert tuple(tcache["cross_k"][0].shape) == (
                2, 4096, cfg.num_kv_heads, cfg.resolved_head_dim)
            pairs = [(tcache["kv"], jcache["kv"])]
            for i in range(L):
                for key in ("cross_k", "cross_v"):
                    _held(tcache[key][i], jcache[key][i], 0.0, key)
        for entries, stacked in pairs:
            for i, entry in enumerate(entries):
                for f, leaf in zip(entry._fields, entry):
                    want = getattr(stacked, f)
                    if isinstance(leaf, torch.Tensor):
                        _held(leaf, want[i], F32_REL, (arch, f, i))
                    else:
                        assert leaf == int(want[i]), (arch, f, i)


def test_encdec_cross_attention_uses_encoder():
    """``tests/test_models.py::test_encdec_cross_attention_uses_encoder``
    on the port: moving the source frames moves the logits."""
    _, _, tm = _models("seamless-m4t-large-v2")
    rng = np.random.default_rng(1)
    tok = rng.integers(0, tm.cfg.vocab_size, (1, 16)).astype(np.int32)
    src1 = rng.normal(0, 1, (1, 16, tm.cfg.d_model)).astype(np.float32)
    l1, _ = tm.forward({"src_embeds": src1, "tokens": tok})
    l2, _ = tm.forward({"src_embeds": src1 + 1.0, "tokens": tok})
    assert not torch.allclose(l1, l2, atol=1e-4)


@pytest.mark.parametrize("arch,calls", [
    ("seamless-m4t-large-v2", [False, False, True, True]),
    ("zamba2-7b", [True]), ("rwkv6-7b", [])])
def test_flash_glue_in_the_encoder_and_the_shared_block(arch, calls,
                                                        monkeypatch):
    """The forward takes the flash kernel's glue (on the CPU its plain
    version, counted here with its ``causal``) in seamless's encoder
    (non-causal, one call a layer) and decoder (causal), and in zamba2's
    shared block (one call an application); none on decode, none with
    ``kernel=False``, none in RWKV."""
    _, _, tm = _models(arch)
    seen = []
    plain = tflash.plain_flash_attention
    monkeypatch.setattr(tflash, "plain_flash_attention",
                        lambda q, k, v, causal=True, **kw: seen.append(
                            causal) or plain(q, k, v, causal, **kw))
    batch = _batch(tm.cfg, 64)
    got, _ = tm.forward(batch)
    assert seen == calls
    want, _ = tm.forward(batch, kernel=False)
    tm.decode_step(tm.init_cache(2, 4, torch.float32), _t(
        batch["tokens"][:, :1]), 0)
    assert seen == calls
    _held(got, want, F32_REL)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_match_reference(arch):
    """The built model holds as many parameters as the reference's
    ``init`` tree, under its paths; ``cfg.param_count()`` (the analytic
    count) equals the reference's, full and reduced."""
    jm, params, tm = _models(arch)
    assert sum(p.numel() for p in tm.parameters()) == sum(
        a.size for a in jax.tree.leaves(params))
    for full in (True, False):
        a = get_config(arch) if full else tm.cfg
        b = j_get_config(arch) if full else jm.cfg
        assert a.param_count() == b.param_count()
    names = set(tm.paths())
    want = {"rwkv6-7b": {"blocks/1/w_lora2", "blocks/0/u", "embed"},
            "zamba2-7b": {"blocks/1/A_log", "shared_attn/attn/wq",
                          "shared_attn/mlp/wd"},
            "seamless-m4t-large-v2": {"enc_blocks/1/attn/wk",
                                      "blocks/0/xattn/wv", "blocks/1/ln_x"},
            }[arch]
    assert want <= names


@pytest.mark.parametrize("arch", ["zamba2-7b", "seamless-m4t-large-v2"])
def test_checkpoint_round_trip(arch, tmp_path):
    """The model's parameters (``shared_attn/...``, ``enc_blocks/<i>/...``)
    and its AdamW state through ``checkpoint.save`` / ``restore`` into a
    fresh model: every leaf equal, bit for bit."""
    from repro_torch.launch import steps
    _, _, tm = _models(arch)
    opt = steps.default_optimizer()
    state = opt.init(tm.paths())
    tckpt.save(str(tmp_path), 3, {"params": tm.paths(), "opt": state})
    fresh = build_model(tm.cfg, device="cpu").init(torch.Generator())
    target = {"params": fresh.paths(), "opt": opt.init(fresh.paths())}
    got = tckpt.restore(str(tmp_path), 3, target)
    assert sorted(got["params"]) == sorted(tm.paths())
    for k, p in tm.paths().items():
        assert torch.equal(got["params"][k], p), k
    assert int(got["opt"].step) == int(state.step)
