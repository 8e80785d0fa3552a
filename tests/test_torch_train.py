"""The port's training path against the JAX package, on the CPU.

The reference runs in process on the JAX CPU backend; its
``DecoderLM.init`` parameters are carried across as numpy
(``model_zoo.params_from_numpy``), and so are its gradients and AdamW
moments, which have the parameters' tree shape, so every leaf is compared
by its tree path. Held to the reference:

* ``AdamW`` (float32 and bf16, clipping on and off, several steps),
  ``global_norm`` and ``cosine_schedule``: the types of the gradients and
  moments equal, the values within 16 float32 ulps of the leaf's largest
  with clipping (the clip scale is a float32 norm that the two libraries
  sum in another order, a few ulps apart, and the moments carry it
  through the steps) and exact without;
* one train step of the 10 reduced configs at ``[2, 64]``: the
  loss within 1e-5 relative, every gradient leaf within 1e-4 of its
  max|g|, the moments as the gradients, and the new parameters (see
  :func:`_params_held`); ``accum_steps=2``; bf16 parameters' gradient and
  moment types with and without clipping and with accumulation;
* 20 steps of reduced granite-8b against the reference's 20 losses
  (``tests/test_system.py::test_training_reduces_loss``).

Also: remat ``none``/``block``/``dots`` give identical gradients (OLMoE
and the hybrid's Mamba2 layers and shared block), a train
step calls the flash glue zero times, and the ``launch/train.py`` CLI.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.core.compat import make_mesh, set_mesh
from repro.launch import steps as jsteps
from repro.models.model_zoo import build_model as j_build_model
from repro.optim import adamw as jadamw
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.kernels import flash_attention as tflash
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import model_zoo as tzoo
from repro_torch.models import transformer as ttrans
from repro_torch.models.model_zoo import build_model, params_from_numpy
from repro_torch.optim import adamw as tadamw

DECODERS = ["granite-8b", "h2o-danube-3-4b", "internlm2-1.8b", "qwen2-1.5b",
            "qwen2-vl-7b", "mixtral-8x22b", "olmoe-1b-7b"]
#: every arch: the decoders, then the recurrent, hybrid and
#: encoder-decoder ones
ARCHS = DECODERS + ["rwkv6-7b", "zamba2-7b", "seamless-m4t-large-v2"]
U = 2.0 ** -24
#: AdamW with clipping: values within this share of the leaf's max|x|
ADAMW_REL = 16 * U
#: one train step: the loss within this share of itself ...
LOSS_REL = 1e-5
#: ... and every gradient leaf within this share of its max|g|
GRAD_REL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _dtype(t):
    return str(t.dtype).split(".")[-1]


def _cfg(get, arch, **replace):
    return dataclasses.replace(get(arch).reduced(), **replace)


def _models(arch, **replace):
    """The reduced config's reference model and params, and the port's
    model on the CPU with those params."""
    jm = j_build_model(_cfg(j_get_config, arch, **replace))
    params = jm.init(jax.random.key(0))
    tm = params_from_numpy(build_model(_cfg(get_config, arch, **replace),
                                       device="cpu"),
                           jax.tree.map(np.asarray, params))
    return jm, params, tm


def _paths(cfg, tree):
    """A reference tree of the parameters' shape (grads, moments, new
    params) by the port's tree paths, as float32 numpy."""
    m = params_from_numpy(build_model(cfg, device="cpu"),
                          jax.tree.map(_np32, tree))
    return {k: p.detach().numpy() for k, p in m.paths().items()}


def _batch(cfg, B=2, S=64, step=0):
    return tpipe.synth_batch(cfg, ShapeConfig("t", S, B, "train"), step)


def _jbatch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _held(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol, (what, err, tol)


# ---------------------------------------------------------------------------
# AdamW, global_norm, cosine_schedule
# ---------------------------------------------------------------------------

SHAPES = {"a": (3, 4), "b/c": (5,), "d": (2, 3, 2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_matches_reference(dtype, clip):
    """Six steps on a random tree: parameters, ``mu`` and ``nu`` of the
    reference's types (bf16 moments turn float32 under clipping, whose
    float32 scale promotes the gradients) and values; exact without
    clipping, within ``ADAMW_REL`` of each leaf's max with it."""
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in SHAPES.items()}
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jp = {k: jnp.asarray(v).astype(jd) for k, v in p0.items()}
    tp = {k: _t(v).to(td) for k, v in p0.items()}
    jo = jadamw.AdamW(lr=jadamw.cosine_schedule(1e-2, 2, 10), clip_norm=clip)
    to = tadamw.AdamW(lr=tadamw.cosine_schedule(1e-2, 2, 10), clip_norm=clip)
    js, ts = jo.init(jp), to.init(tp)
    want_moment = "float32" if clip else dtype
    for i in range(6):
        g = {k: (rng.standard_normal(s) * 3).astype(np.float32)
             for k, s in SHAPES.items()}
        jp, js = jo.update({k: jnp.asarray(v).astype(jd)
                            for k, v in g.items()}, js, jp)
        same, ts = to.update({k: _t(v).to(td) for k, v in g.items()}, ts, tp)
        assert same is tp
        assert ts.step.dtype == torch.int32 and int(ts.step) == i + 1
        for k in SHAPES:
            for what, want, got in (("p", jp[k], tp[k]), ("mu", js.mu[k],
                                                         ts.mu[k]),
                                    ("nu", js.nu[k], ts.nu[k])):
                assert _dtype(got) == str(want.dtype), (what, k)
                if what != "p":
                    assert _dtype(got) == want_moment
                tol = ADAMW_REL * float(np.abs(_np32(want)).max()) if clip \
                    else 0.0
                _held(got.float().numpy(), _np32(want), tol, (i, what, k))


def test_global_norm_and_cosine_schedule_match_reference():
    rng = np.random.default_rng(1)
    tree = {k: rng.standard_normal(s).astype(np.float32) * 10
            for k, s in SHAPES.items()}
    want = float(jadamw.global_norm({k: jnp.asarray(v)
                                     for k, v in tree.items()}))
    got = tadamw.global_norm({k: _t(v) for k, v in tree.items()})
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 2 * U * want
    for peak, warm, total, floor in ((3e-4, 100, 10_000, 0.1),
                                     (1.0, 10, 100, 0.1), (3e-3, 5, 100, 0.0),
                                     (1.0, 0, 50, 0.2)):
        jl = jadamw.cosine_schedule(peak, warm, total, floor)
        tl = tadamw.cosine_schedule(peak, warm, total, floor)
        for s in (0, 1, 4, 5, 6, 10, 37, 99, 100, 101, 5000, 10_000, 20_000):
            want = float(jl(jnp.array(s, jnp.int32)))
            got = tl(torch.tensor(s, dtype=torch.int32))
            assert got.dtype == torch.float32
            assert abs(float(got) - want) <= 2 * U * peak, (peak, warm, s)


# ---------------------------------------------------------------------------
# one train step of the 7 reduced decoder configs
# ---------------------------------------------------------------------------

def _params_held(got, p0, want, g_want, lr1, what):
    """New parameters after AdamW's first step, where the update is
    ``lr (g / (|g| + eps) + wd p)``: a gradient near 0 may take the other
    sign in another float order, so each entry may move up to ``2 lr``
    apart; where |g| is at least 1e-3 of the leaf's max|g| (1e4 times
    ``GRAD_REL``: its sign and size are the reference's) within 1e-3 of
    lr. Both plus 2 float32 ulps of |p|."""
    ulp = 2 * 2.0 ** -23 * np.abs(p0)
    err = np.abs(got.astype(np.float64) - want)
    assert (err <= 2 * lr1 + ulp).all(), (what, err.max(), lr1)
    firm = np.abs(g_want) >= 1e-3 * np.abs(g_want).max()
    assert (err[firm] <= 1e-3 * lr1 + ulp[firm]).all(), (
        what, err[firm].max(), lr1)


def _ref_step(jm, params, batch, opt):
    @jax.jit
    def step(params, batch):
        (loss, metrics), grads = jax.value_and_grad(jm.loss, has_aux=True)(
            params, batch)
        new, state = opt.update(grads, opt.init(params), params)
        return loss, metrics, grads, new, state
    return step(params, _jbatch(batch))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """``make_train_step`` with ``default_optimizer()`` against the
    reference's ``value_and_grad(loss)`` + ``update`` from the same
    weights and batch: loss, every gradient leaf (by tree path), ``mu``
    and ``nu`` (held as their gradients, scaled), the new parameters."""
    jm, params, tm = _models(arch)
    cfg = tm.cfg
    batch = _batch(cfg)
    loss, jmetrics, grads, new, state = _ref_step(
        jm, params, batch, jsteps.default_optimizer())
    opt = tsteps.default_optimizer()
    p0 = {k: v.detach().clone().numpy() for k, v in tm.paths().items()}
    metrics, tgrads = tsteps.loss_and_grads(tm, batch)
    step = tsteps.make_train_step(tm, opt)
    tparams, tstate, tmetrics = step(tm.paths(), opt.init(tm.paths()), batch)
    for key in ("loss", "ce", "aux"):
        for m in (metrics, tmetrics):
            _held(m[key], jmetrics[key],
                  LOSS_REL * max(1.0, abs(float(jmetrics[key]))), key)
    g_want = _paths(cfg, grads)
    assert sorted(tgrads) == sorted(g_want) == sorted(tparams)
    lr1 = float(opt.lr(torch.tensor(1, dtype=torch.int32)))
    mu, nu, p1 = (_paths(cfg, t) for t in (state.mu, state.nu, new))
    for k, want in g_want.items():
        scale = float(np.abs(want).max())
        _held(tgrads[k].numpy(), want, GRAD_REL * scale, ("grad", k))
        # step 1: mu = (1 - b1) g', nu = (1 - b2) g'^2, g' clipped
        _held(tstate.mu[k].numpy(), mu[k], GRAD_REL * float(
            np.abs(mu[k]).max()), ("mu", k))
        _held(tstate.nu[k].numpy(), nu[k], 3 * GRAD_REL * float(
            np.abs(nu[k]).max()), ("nu", k))
        _params_held(tparams[k].detach().numpy(), p0[k], p1[k], want, lr1,
                     k)
    assert tstate.step.dtype == torch.int32 and int(tstate.step) == 1


def test_accumulated_train_step_matches_reference():
    """``accum_steps=2`` on [4, 32] (two contiguous micro-batches of 2):
    the averaged metrics, ``mu`` (the float32 mean gradient, clipped) and
    the new parameters against the reference's ``make_train_step``."""
    jm, params, tm = _models("olmoe-1b-7b")
    cfg = tm.cfg
    batch = _batch(cfg, B=4, S=32)
    mesh = make_mesh((1, 1), ("data", "model"))
    jopt = jsteps.default_optimizer()
    jstep = jsteps.make_train_step(jm, jopt, mesh, accum_steps=2)
    with set_mesh(mesh):
        new, state, jmetrics = jax.jit(jstep)(params, jopt.init(params),
                                              _jbatch(batch))
    opt = tsteps.default_optimizer()
    p0 = {k: v.detach().clone().numpy() for k, v in tm.paths().items()}
    step = tsteps.make_train_step(tm, opt, accum_steps=2)
    tparams, tstate, tmetrics = step(tm.paths(), opt.init(tm.paths()), batch)
    for key in ("loss", "ce", "aux"):
        _held(tmetrics[key], jmetrics[key],
              LOSS_REL * max(1.0, abs(float(jmetrics[key]))), key)
    mu, p1 = _paths(cfg, state.mu), _paths(cfg, new)
    lr1 = float(opt.lr(torch.tensor(1, dtype=torch.int32)))
    for k, want in mu.items():
        assert tstate.mu[k].dtype == torch.float32
        _held(tstate.mu[k].numpy(), want, GRAD_REL * float(
            np.abs(want).max()), ("mu", k))
        _params_held(tparams[k].detach().numpy(), p0[k], p1[k], want, lr1,
                     k)


@pytest.mark.parametrize("clip,accum", [(1.0, 1), (0.0, 1), (0.0, 2)])
def test_bf16_parameters_keep_the_reference_types(clip, accum):
    """bf16 parameters (float32 activations): bf16 gradients; the
    moments bf16 without clipping, float32 under it (the float32 clip
    scale promotes the gradients) and under accumulation (the float32
    accumulator does); the new parameters bf16 and within one bf16 ulp
    of the reference's, or ``2 lr`` where a gradient near 0 turned."""
    jm, params, tm = _models("granite-8b")
    cfg = tm.cfg
    bparams = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    tm.to(torch.bfloat16)
    batch = _batch(cfg, B=2, S=32)
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(), clip_norm=clip)
    opt = tadamw.AdamW(lr=tadamw.cosine_schedule(), clip_norm=clip)
    mesh = make_mesh((1, 1), ("data", "model"))
    with set_mesh(mesh):
        new, state, _ = jax.jit(jsteps.make_train_step(
            jm, jopt, mesh, accum_steps=accum))(bparams, jopt.init(bparams),
                                                _jbatch(batch))
    if accum == 1:
        _, grads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
            bparams, _jbatch(batch))
        _, tgrads = tsteps.loss_and_grads(tm, batch)
        assert {str(g.dtype) for g in jax.tree.leaves(grads)} == {
            _dtype(g) for g in tgrads.values()} == {"bfloat16"}
    step = tsteps.make_train_step(tm, opt, accum_steps=accum)
    tparams, tstate, _ = step(tm.paths(), opt.init(tm.paths()), batch)
    for moments, want in ((tstate.mu, state.mu), (tstate.nu, state.nu)):
        assert {str(m.dtype) for m in jax.tree.leaves(want)} == {
            _dtype(m) for m in moments.values()}
    assert {_dtype(m) for m in tstate.mu.values()} == {
        "float32" if clip or accum > 1 else "bfloat16"}
    p1 = _paths(cfg, new)
    lr1 = float(opt.lr(torch.tensor(1, dtype=torch.int32)))
    for k, want in p1.items():
        got = tparams[k].detach()
        assert got.dtype == torch.bfloat16
        got = got.float().numpy()
        err = np.abs(got - want)
        assert (err <= 2 * lr1 + 2.0 ** -8 * np.abs(want)).all(), k


def test_remat_policies_give_identical_gradients(monkeypatch):
    """``remat`` none / block / dots on reduced OLMoE through the einsum
    MoE and on reduced zamba2 (``HybridLM``: two Mamba2 layers, one
    application of the shared block): the same loss and gradients, bit
    for bit; ``block`` and ``dots`` run each block twice (forward, then
    its recompute in the backward pass; ``dots`` takes the matrix
    products' outputs from the forward). The shared block is
    rematerialised by a plain checkpoint under ``dots`` too, as the
    reference's ``jax.checkpoint``."""
    for arch, blocks in (("olmoe-1b-7b", [(ttrans, "decoder_block")]),
                         ("zamba2-7b", [(tzoo, "decoder_block"),
                                        (tzoo, "mamba_block")])):
        _, _, tm = _models(arch)
        batch = _batch(tm.cfg, S=32)
        calls = {}
        for module, name in blocks:
            real = getattr(module, name)

            def counted(*a, _name=name, _real=real, **k):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(*a, **k)
            monkeypatch.setattr(module, name, counted)
        once = ({"decoder_block": tm.cfg.num_layers} if arch == "olmoe-1b-7b"
                else {"mamba_block": tm.cfg.num_layers, "decoder_block": 1})
        out = {}
        for remat in ("none", "block", "dots"):
            m = build_model(dataclasses.replace(tm.cfg, remat=remat),
                            device="cpu")
            m.load(tm.tree())
            calls.clear()
            out[remat] = tsteps.loss_and_grads(m, batch)
            assert calls == {k: n if remat == "none" else 2 * n
                             for k, n in once.items()}, (arch, remat)
        for remat in ("block", "dots"):
            assert torch.equal(out[remat][0]["loss"], out["none"][0]["loss"])
            for k, g in out["none"][1].items():
                assert torch.equal(out[remat][1][k], g), (arch, remat, k)


def test_train_step_never_calls_the_flash_glue(monkeypatch):
    """The train step's forward runs ``kernel=False``: zero calls of the
    flash kernel's plain version (the glue's CPU path), where the serving
    forward of the same model calls it once a layer."""
    _, _, tm = _models("granite-8b")
    seen = []
    plain = tflash.plain_flash_attention
    monkeypatch.setattr(tflash, "plain_flash_attention",
                        lambda *a, **k: seen.append(1) or plain(*a, **k))
    opt = tsteps.default_optimizer()
    step = tsteps.make_train_step(tm, opt)
    batch = _batch(tm.cfg, S=32)
    step(tm.paths(), opt.init(tm.paths()), batch)
    assert seen == []
    tsteps.make_prefill_step(tm)(batch)
    assert len(seen) == tm.cfg.num_layers


def test_twenty_steps_follow_the_reference_losses():
    """``tests/test_system.py::test_training_reduces_loss`` on both
    packages from the same weights: reduced granite-8b, AdamW at peak
    3e-3 (warmup 5, total 100), one batch [4, 32] 20 times. Each loss
    within 1e-4 of the reference's, relative (float32 sums in another
    order, through 20 updates), and the last below 0.7 of the first."""
    jm, params, tm = _models("granite-8b")
    jopt = jadamw.AdamW(lr=jadamw.cosine_schedule(3e-3, 5, 100))
    opt = tadamw.AdamW(lr=tadamw.cosine_schedule(3e-3, 5, 100))
    tok = np.random.default_rng(0).integers(
        0, tm.cfg.vocab_size, (4, 32)).astype(np.int32)
    batch = {"tokens": tok, "labels": tok}

    @jax.jit
    def jstep(p, s, b):
        (loss, _), g = jax.value_and_grad(jm.loss, has_aux=True)(p, b)
        p, s = jopt.update(g, s, p)
        return p, s, loss

    state, want = jopt.init(params), []
    for _ in range(20):
        params, state, loss = jstep(params, state, _jbatch(batch))
        want.append(float(loss))
    step = tsteps.make_train_step(tm, opt)
    tparams, tstate, got = tm.paths(), opt.init(tm.paths()), []
    for _ in range(20):
        tparams, tstate, metrics = step(tparams, tstate, batch)
        got.append(float(metrics["loss"]))
    assert np.allclose(got, want, rtol=1e-4, atol=0), (got, want)
    assert got[-1] < 0.7 * got[0]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_train_cli_runs_on_the_cpu(capsys, tmp_path):
    res = ttrain.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                       "cpu", "--steps", "4", "--batch", "2", "--seq", "32",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                       "--log-every", "2"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert [ln.split(":")[0] for ln in lines[:-1]] == [
        "step 0", "step 2", "step 3"]
    assert lines[-1].startswith("done: 4 steps, ") and "on cpu" in out
    assert res.final_step == 4 and len(res.metrics_history) == 4
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001", "step_00000003"]
    # a second run resumes after the last checkpoint: nothing left to do
    again = ttrain.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                         "cpu", "--steps", "4", "--batch", "2", "--seq", "32",
                         "--ckpt-dir", str(tmp_path)])
    assert again.final_step == 4 and again.metrics_history == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttrain.main(["--reduced", "--steps", "1"])
