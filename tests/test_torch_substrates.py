"""The port's training substrates against the JAX package, on the CPU:
the cases of ``tests/test_substrates.py`` and
``tests/test_resilience.py::test_run_training_uses_shared_retry_ledger``,
each run on both packages and held to the reference's behaviour, and:

* checkpoints: the same nested tree gives the same manifest and the same
  file bytes; bf16 leaves cross both ways; restore refuses a shape;
  ``rescale_from_checkpoint`` lays leaves out by their ``Sharding``;
* ``quantize_int8`` / ``dequantize`` equal to the reference's, and
  ``compress_psum`` per shard as the reference computes it in
  ``shard_map``, then converging on ``Fabric.fake(8)`` as
  ``tests/test_compression_distributed.py`` asserts (exact < 0.05,
  compressed < 0.15).
"""
import json
import os

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax
import jax.numpy as jnp

from repro.checkpoint import checkpoint as jckpt
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.runtime import fault_tolerance as jft
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core.fabric import Fabric
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamW, cosine_schedule, global_norm
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime.elastic import (ShardedArray, Sharding,
                                         rescale_from_checkpoint)

U = 2.0 ** -24


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def test_adamw_converges_quadratic_as_reference():
    """200 steps on sum(w^2) from [5, -3]: |w| < 1e-2, and the path the
    reference's takes, within 1e-6 of |w0|."""
    opt = AdamW(lr=lambda s: 0.1, weight_decay=0.0, clip_norm=0.0)
    jopt = jadamw.AdamW(lr=lambda s: 0.1, weight_decay=0.0, clip_norm=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    jparams = {"w": jnp.array([5.0, -3.0])}
    state, jstate = opt.init(params), jopt.init(jparams)
    for _ in range(200):
        w = params["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.sum(w ** 2), [w])
        params, state = opt.update({"w": g}, state, params)
        jg = jax.grad(lambda p: jnp.sum(p["w"] ** 2))(jparams)
        jparams, jstate = jopt.update(jg, jstate, jparams)
    assert float(params["w"].abs().max()) < 1e-2
    assert np.abs(params["w"].numpy() - np.asarray(jparams["w"])).max() \
        <= 1e-6 * 5.0


def test_grad_clipping_as_reference():
    opt = AdamW(lr=lambda s: 1e-3, clip_norm=1.0)
    jopt = jadamw.AdamW(lr=lambda s: 1e-3, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    state = opt.init(params)
    _, state = opt.update({"w": torch.full((3,), 1e6)}, state, params)
    jparams = {"w": jnp.zeros(3)}
    _, jstate = jopt.update({"w": jnp.full(3, 1e6)}, jopt.init(jparams),
                            jparams)
    assert float(global_norm(state.mu)) <= 0.11   # clipped before moments
    assert abs(float(global_norm(state.mu))
               - float(jadamw.global_norm(jstate.mu))) <= 4 * U * 0.1


def test_cosine_schedule_shape():
    lr = cosine_schedule(peak_lr=1.0, warmup=10, total=100)
    for s, want in ((0, 0.0), (10, 1.0), (100, 0.1)):
        got = float(lr(torch.tensor(s)))
        assert got == pytest.approx(want, abs=1e-2)
        assert got == pytest.approx(float(jadamw.cosine_schedule(
            peak_lr=1.0, warmup=10, total=100)(jnp.array(s))), abs=1e-7)


# ---------------------------------------------------------------------------
# int8 error-feedback compression
# ---------------------------------------------------------------------------

@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_quantize_roundtrip_bounded_and_equal_to_reference(seed):
    x = np.random.default_rng(seed).standard_normal(128).astype(np.float32)
    q, scale = comp.quantize_int8(_t(x))
    jq, jscale = jcomp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and scale.shape == ()
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)
    back = comp.dequantize(q, scale)
    assert np.array_equal(back.numpy(), np.asarray(jcomp.dequantize(jq,
                                                                    jscale)))
    assert float((back - _t(x)).abs().max()) <= float(scale) * 0.5 + 1e-6


def test_error_feedback_preserves_signal():
    """With EF the accumulated compressed signal tracks the true sum, as
    the reference's does (the two sums equal)."""
    g_true = np.random.default_rng(0).normal(0, 1, (64,)).astype(np.float32)
    residual, acc = torch.zeros(64), torch.zeros(64)
    jresidual, jacc = jnp.zeros(64), jnp.zeros(64)
    for _ in range(50):
        q, s = comp.quantize_int8(_t(g_true) + residual)
        sent = comp.dequantize(q, s)
        residual = (_t(g_true) + residual) - sent
        acc = acc + sent
        jq, js = jcomp.quantize_int8(jnp.asarray(g_true) + jresidual)
        jsent = jcomp.dequantize(jq, js)
        jresidual = (jnp.asarray(g_true) + jresidual) - jsent
        jacc = jacc + jsent
    assert float((acc / 50 - _t(g_true)).abs().max()) < 0.02
    assert np.array_equal(acc.numpy(), np.asarray(jacc))


def test_compress_psum_is_the_reference_per_shard():
    """Per shard s: quantize(g_s + r_s) with its own scale, the int sum
    and the mean scale over the data axis, divided by the participants,
    as the reference's body computes on each device; residuals exact,
    means within 4 float32 ulps (the scales summed in another order)."""
    fab = Fabric.virtual((2, 4), ("pod", "data"), device="cpu")
    rng = np.random.default_rng(3)
    g = rng.standard_normal((8, 5, 3)).astype(np.float32)
    r = (rng.standard_normal((8, 5, 3)) * 0.01).astype(np.float32)
    out, ef = comp.compress_psum({"g": _t(g)}, comp.EFState({"g": _t(r)}),
                                 fab, "data")
    qs = [jcomp.quantize_int8(jnp.asarray(g[s] + r[s])) for s in range(8)]
    for s in range(8):
        peers = [p for p in range(8) if p // 4 == s // 4]
        qsum = sum(np.asarray(qs[p][0], np.int32) for p in peers)
        ssum = np.float32(sum(np.float32(qs[p][1]) for p in peers))
        want = qsum.astype(np.float32) * (ssum / 4) / 4
        assert np.abs(out["g"][s].numpy() - want).max() <= 4 * U * np.abs(
            want).max()
        want_r = (g[s] + r[s]) - np.asarray(jcomp.dequantize(*qs[s]))
        assert np.array_equal(ef.residual["g"][s].numpy(), want_r)
    # over every axis the sum is the fabric's gsum: one mean on all shards
    out, _ = comp.compress_psum({"g": _t(g)}, comp.init_ef({"g": _t(g)}),
                                fab, ("pod", "data"))
    assert torch.equal(out["g"], out["g"][:1].expand_as(out["g"]))


def test_compressed_data_parallel_converges():
    """``tests/test_compression_distributed.py`` on ``Fabric.fake(8)``:
    least squares, the rows sharded over 8 shards, AdamW at 0.05, 150
    steps, the gradients averaged exactly (psum / 8) or through
    ``compress_psum``."""
    fab = Fabric.fake(8, device="cpu")
    rng = np.random.default_rng(0)
    w_star = _t(rng.normal(0, 1, (16,)).astype(np.float32))
    X = _t(rng.normal(0, 1, (64, 16)).astype(np.float32))
    y = X @ w_star
    Xs, ys = fab.shard(X, ("data",)), fab.shard(y, ("data",))
    opt = AdamW(lr=lambda s: 0.05, weight_decay=0.0, clip_norm=0.0)
    results = {}
    for compress in (False, True):
        params = {"w": torch.zeros(16)}
        state = opt.init(params)
        ef = comp.init_ef({"w": torch.zeros(8, 16)})
        for _ in range(150):
            w = params["w"].detach().expand(8, 16).clone().requires_grad_(True)
            loss = ((Xs @ w[..., None])[..., 0] - ys).square().mean(1).sum()
            (g,) = torch.autograd.grad(loss, [w])
            if compress:
                gs, ef = comp.compress_psum({"w": g}, ef, fab, ("data",))
                mean = gs["w"]
            else:
                mean = fab.psum(g, "data") / 8
            assert torch.equal(mean, mean[:1].expand_as(mean))
            params, state = opt.update({"w": mean[0]}, state, params)
        results[compress] = float((params["w"] - w_star).abs().max())
    assert results[False] < 0.05
    assert results[True] < 0.15


# ---------------------------------------------------------------------------
# checkpoint / restore / elastic
# ---------------------------------------------------------------------------

def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"b": {"c": np.ones(5, np.int32), "a": rng.standard_normal(
                (2, 3)).astype(np.float32)},
            "a": rng.standard_normal((3, 4)).astype(np.float32),
            "s": (np.float32(2.5), np.arange(3, dtype=np.int32)),
            "h": rng.standard_normal(6).astype(np.float32)}


def _bf16(tree, lib):
    """``tree`` with its leaf "h" in bf16 (of the library ``lib``)."""
    out = dict(tree)
    out["h"] = (jnp.asarray(tree["h"]).astype(jnp.bfloat16) if lib == "jax"
                else _t(tree["h"]).to(torch.bfloat16))
    return out


def test_checkpoint_manifests_and_files_equal_the_reference(tmp_path):
    """The same nested tree (mappings in any key order, a tuple, a 0-d
    leaf, int32, float32 and a bf16 leaf) saved by both packages: equal
    manifests, byte-identical files."""
    tree = _tree()
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jckpt.save(str(jdir), 7, _bf16(jax.tree.map(jnp.asarray, tree), "jax"))
    ttree = _bf16({"s": tuple(_t(np.asarray(v)) for v in tree["s"]),
                   "a": _t(tree["a"]), "h": tree["h"],
                   "b": {"a": _t(tree["b"]["a"]), "c": _t(tree["b"]["c"])}},
                  "torch")
    ckpt.save(str(tdir), 7, ttree)
    jman = json.loads((jdir / "step_00000007" / "manifest.json").read_text())
    tman = json.loads((tdir / "step_00000007" / "manifest.json").read_text())
    assert tman == jman
    assert [e["dtype"] for e in tman["keys"]] == [
        "float32", "float32", "int32", "bfloat16", "float32", "int32"]
    for e in tman["keys"]:
        assert (tdir / "step_00000007" / e["file"]).read_bytes() == (
            jdir / "step_00000007" / e["file"]).read_bytes(), e["key"]


def test_bf16_checkpoints_cross_both_ways(tmp_path):
    """The port restores the reference's bf16 leaf bit for bit, and the
    reference restores the port's checkpoint of a tree without one. A
    deliberate difference: the reference cannot restore a bf16 leaf, its
    own or the port's (``np.load`` gives raw ``<V2`` records, which numpy
    cannot cast to ``ml_dtypes``' bfloat16); it raises alike on both
    files, which are the same bytes."""
    tree = _tree(1)
    jtree = _bf16(jax.tree.map(jnp.asarray, tree), "jax")
    ttree = _bf16(jax.tree.map(_t, tree), "torch")
    jckpt.save(str(tmp_path / "j"), 1, jtree)
    ckpt.save(str(tmp_path / "t"), 1, ttree)
    got = ckpt.restore(str(tmp_path / "j"), 1, ttree)      # reference -> port
    assert got["h"].dtype == torch.bfloat16
    assert torch.equal(got["h"].view(torch.int16), ttree["h"].view(
        torch.int16))
    for k in ("a", "b", "s"):
        for x, y in zip(jax.tree.leaves(tree[k]), jax.tree.leaves(got[k])):
            assert np.array_equal(np.asarray(x), y.numpy()), k
    for d in ("j", "t"):
        with pytest.raises(ValueError, match="No cast function"):
            jckpt.restore(str(tmp_path / d), 1, jtree)
    plain = {k: v for k, v in tree.items() if k != "h"}
    ckpt.save(str(tmp_path / "t2"), 2, jax.tree.map(_t, plain))
    back = jckpt.restore(str(tmp_path / "t2"), 2,
                         jax.tree.map(jnp.asarray, plain))  # port -> reference
    for x, y in zip(jax.tree.leaves(plain), jax.tree.leaves(back)):
        assert np.array_equal(np.asarray(x), np.asarray(y))
        assert np.asarray(x).dtype == np.asarray(y).dtype


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(12.0).reshape(3, 4),
            "b": {"c": torch.ones(5, dtype=torch.int32)}}
    ckpt.save(str(tmp_path), 3, tree)
    assert ckpt.latest_step(str(tmp_path)) == 3
    out = ckpt.restore(str(tmp_path), 3, {"a": torch.zeros(3, 4),
                                          "b": {"c": torch.zeros(
                                              5, dtype=torch.int32)}})
    assert torch.equal(out["a"], tree["a"])
    assert torch.equal(out["b"]["c"], tree["b"]["c"])
    assert out["b"]["c"].dtype == torch.int32
    with pytest.raises(ValueError, match="checkpoint shape"):
        ckpt.restore(str(tmp_path), 3, {"a": torch.zeros(4, 3),
                                        "b": {"c": torch.zeros(5)}})


def test_checkpoint_retention(tmp_path):
    for s in range(5):
        ckpt.save(str(tmp_path), s, {"a": torch.zeros(2)}, keep=2)
        jckpt.save(str(tmp_path / "j"), s, {"a": jnp.zeros(2)}, keep=2)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == sorted(os.listdir(tmp_path / "j"))
    assert len(steps) == 2 and steps[-1] == "step_00000004"
    assert ckpt.latest_step(str(tmp_path / "none")) is None


def test_checkpoint_atomicity_no_tmp_left(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros(2)})
    (tmp_path / "step_00000002.tmp").mkdir()     # a crash mid-write
    assert ckpt.latest_step(str(tmp_path)) == 1
    ckpt.save(str(tmp_path), 2, {"a": torch.ones(2)})
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    assert ckpt.latest_step(str(tmp_path)) == 2


def test_rescale_from_checkpoint_places_each_leaf(tmp_path):
    """A state saved from 8 shards restores onto a 4-shard fabric by its
    target shardings (``None``: the target leaf's device), and saving a
    ``ShardedArray`` writes its global array."""
    w = torch.arange(32.0).reshape(8, 4)
    src = Fabric.fake(8, device="cpu")
    sharded = ShardedArray(src.shard(w, ("data",)), Sharding(src, ("data",)))
    ckpt.save(str(tmp_path), 0, {"w": sharded, "step": torch.tensor(3)})
    dst = Fabric.fake(4, device="cpu")
    out = rescale_from_checkpoint(
        str(tmp_path), 0, {"w": torch.zeros(8, 4), "step": torch.tensor(0)},
        {"w": Sharding(dst, ("data",)), "step": None})
    assert isinstance(out["w"], ShardedArray)
    assert out["w"].blocks.shape == (4, 2, 4)
    assert torch.equal(out["w"].global_array(), w)
    assert int(out["step"]) == 3


# ---------------------------------------------------------------------------
# fault-tolerant loop
# ---------------------------------------------------------------------------

def _toy_problem():
    opt = AdamW(lr=lambda s: 0.05, weight_decay=0.0)

    def init_state():
        params = {"w": torch.tensor([4.0])}
        return params, opt.init(params)

    def step_fn(params, opt_state, batch):
        w = params["w"].detach().requires_grad_(True)
        loss = torch.sum((w - batch) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        params, opt_state = opt.update({"w": g}, opt_state, params)
        return params, opt_state, {"loss": loss.detach()}

    return init_state, step_fn


def _j_toy_problem():
    opt = jadamw.AdamW(lr=lambda s: 0.05, weight_decay=0.0)

    def init_state():
        params = {"w": jnp.array([4.0])}
        return params, opt.init(params)

    def step_fn(params, opt_state, batch):
        loss, g = jax.value_and_grad(
            lambda p: jnp.sum((p["w"] - batch) ** 2))(params)
        params, opt_state = opt.update(g, opt_state, params)
        return params, opt_state, {"loss": loss}

    return init_state, step_fn


def _losses(res):
    return np.array([m["loss"] for m in res.metrics_history])


def _both(tmp_path, total, plan, **kw):
    """run_training of the toy problem on both packages with the same
    failure plan: (port result, reference result)."""
    init_state, step_fn = _toy_problem()
    got = ft.run_training(step_fn, init_state, lambda s: torch.tensor(1.0),
                          total_steps=total, ckpt_dir=str(tmp_path / "t"),
                          failure_plan=ft.FailurePlan(plan), **kw)
    init_state, step_fn = _j_toy_problem()
    want = jft.run_training(step_fn, init_state, lambda s: jnp.array(1.0),
                            total_steps=total, ckpt_dir=str(tmp_path / "j"),
                            failure_plan=jft.FailurePlan(plan), **kw)
    return got, want


def test_training_recovers_from_injected_failures(tmp_path):
    got, want = _both(tmp_path, 20, {7: "ici-timeout", 13: "preemption"},
                      ckpt_every=5)
    assert (got.final_step, got.restarts) == (want.final_step,
                                              want.restarts) == (20, 2)
    assert np.allclose(_losses(got), _losses(want), rtol=1e-6, atol=1e-12)
    assert got.metrics_history[-1]["loss"] < got.metrics_history[0]["loss"]


def test_training_gives_up_after_max_restarts(tmp_path):
    init_state, step_fn = _toy_problem()
    plan = ft.FailurePlan(at_steps={i: "crash" for i in range(0, 50)})
    with pytest.raises(ft.InjectedFailure):
        ft.run_training(step_fn, init_state, lambda s: torch.tensor(1.0),
                        total_steps=20, ckpt_dir=str(tmp_path),
                        max_restarts=2, failure_plan=plan)
    assert plan.fired == [(0, "crash"), (1, "crash"), (2, "crash")]


def test_straggler_watchdog_flags_slow_steps():
    for mod in (ft, jft):
        wd = mod.StragglerWatchdog(factor=2.0, window=8)
        for i in range(8):
            wd.observe(i, 0.01)
        wd.observe(8, 0.5)
        assert wd.flagged == [8]


def test_restart_does_not_double_count_replayed_steps(tmp_path):
    """ckpt_every 4, a failure at 6: steps 4 and 5 replay; one metrics
    entry and one watchdog observation a step, as the reference keeps."""
    init_state, step_fn = _toy_problem()

    def step_fn_tagged(params, opt_state, batch):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             torch.tensor(1.0))
        return params, opt_state, {**metrics, "step": batch}

    wd = ft.StragglerWatchdog()
    res = ft.run_training(step_fn_tagged, init_state,
                          lambda s: torch.tensor(float(s)), total_steps=12,
                          ckpt_dir=str(tmp_path), ckpt_every=4,
                          failure_plan=ft.FailurePlan({6: "ici-timeout"}),
                          watchdog=wd)
    assert res.restarts == 1
    assert [int(m["step"]) for m in res.metrics_history] == list(range(12))
    assert len(wd.history) == 12 and wd.steps == list(range(12))
    _, want = _both(tmp_path / "b", 12, {6: "ici-timeout"}, ckpt_every=4)
    assert np.allclose([m["loss"] for m in res.metrics_history],
                       _losses(want), rtol=1e-6, atol=1e-12)


def test_watchdog_rollback_drops_flags_of_replayed_steps():
    wd = ft.StragglerWatchdog(factor=2.0, window=8)
    for i in range(8):
        wd.observe(i, 0.01)
    wd.observe(8, 0.5)
    assert 8 in wd.flagged
    wd.rollback(8)
    assert wd.flagged == [] and len(wd.history) == 8


def test_watchdog_median_is_true_median_for_even_windows():
    for mod in (ft, jft):
        wd = mod.StragglerWatchdog(factor=3.0, window=4)
        for i, dt in enumerate([0.001, 0.001, 0.1, 0.1]):
            wd.observe(i, dt)
        wd.observe(4, 0.2)
        assert 4 in wd.flagged


def test_resume_continues_not_restarts(tmp_path):
    """A second call resumes from the checkpoint (momentum kept): only
    steps 10 and 11 run, with the reference's losses."""
    init_state, step_fn = _toy_problem()
    ft.run_training(step_fn, init_state, lambda s: torch.tensor(1.0),
                    total_steps=10, ckpt_dir=str(tmp_path), ckpt_every=5)
    res2 = ft.run_training(step_fn, init_state, lambda s: torch.tensor(1.0),
                           total_steps=12, ckpt_dir=str(tmp_path),
                           ckpt_every=5)
    assert res2.final_step == 12
    assert len(res2.metrics_history) == 2
    jinit, jstep = _j_toy_problem()
    jft.run_training(jstep, jinit, lambda s: jnp.array(1.0), total_steps=10,
                     ckpt_dir=str(tmp_path / "j"), ckpt_every=5)
    want = jft.run_training(jstep, jinit, lambda s: jnp.array(1.0),
                            total_steps=12, ckpt_dir=str(tmp_path / "j"),
                            ckpt_every=5)
    assert np.allclose(_losses(res2), _losses(want), rtol=1e-6, atol=1e-12)


def test_run_training_uses_shared_retry_ledger(tmp_path):
    """Restarts count on the RetryLedger (a retry granted while n <=
    max_retries), as the reference's do: the same final step, restarts
    and history; exhausted, the failure propagates."""
    def init_state():
        return {"w": torch.tensor([4.0])}, {"m": torch.tensor([0.0])}

    def step_fn(params, opt_state, batch):
        params = {"w": params["w"] - 0.1 * batch}
        return params, opt_state, {"loss": float(torch.sum(params["w"]))}

    def j_init():
        return {"w": jnp.array([4.0])}, {"m": jnp.array([0.0])}

    def j_step(params, opt_state, batch):
        params = {"w": params["w"] - 0.1 * batch}
        return params, opt_state, {"loss": float(jnp.sum(params["w"]))}

    plan = {5: "ici-timeout", 9: "preemption"}
    res = ft.run_training(step_fn, init_state, lambda s: torch.tensor(1.0),
                          total_steps=12, ckpt_dir=str(tmp_path / "a"),
                          ckpt_every=4, max_restarts=3,
                          failure_plan=ft.FailurePlan(plan))
    want = jft.run_training(j_step, j_init, lambda s: jnp.array(1.0),
                            total_steps=12, ckpt_dir=str(tmp_path / "ja"),
                            ckpt_every=4, max_restarts=3,
                            failure_plan=jft.FailurePlan(plan))
    assert (res.final_step, res.restarts) == (want.final_step,
                                              want.restarts) == (12, 2)
    assert len(res.metrics_history) == 12
    assert np.allclose(_losses(res), _losses(want), rtol=1e-6)
    with pytest.raises(ft.InjectedFailure):
        ft.run_training(step_fn, init_state, lambda s: torch.tensor(1.0),
                        total_steps=6, ckpt_dir=str(tmp_path / "b"),
                        ckpt_every=100, max_restarts=1,
                        failure_plan=ft.FailurePlan({0: "a", 1: "b", 2: "c"}))
