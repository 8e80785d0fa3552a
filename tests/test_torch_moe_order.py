"""``moe_dcra`` adds in a fixed order, forward and backward, on the CPU.

The combine (each token's K gate-weighted task rows) and the gradient of
the dispatch gather (each token read up to K times) each add several
terms into one row. An add by index (``index_add_``, ``index_select``'s
backward) does that with atomics on the card, in an order that changes
from run to run; the port adds in a fixed order instead. Here:

* the port's combine equals the reference's ``jax.ops.segment_sum`` bit
  for bit, for K in {1, 2, 8}, with -0.0 rows and tokens whose every
  task was dropped;
* a ``TorchDispatchMode`` spy sees no accumulate-by-index op (``aten.
  index_add``, ``index_put`` with ``accumulate=True``, ``scatter_add``,
  ``put_`` with ``accumulate=True``, ``index_reduce``, a summing
  ``scatter_reduce``) in ``moe_dcra``'s forward or backward on a virtual
  fabric, on every packaging of ``tests/test_torch_moe.py``'s ``CASES``
  (fused, tp-sharded FFN, two-stage, two experts a shard, the sequence
  that does not split) and every route impl, nor in a decoder LM's
  train step through it (the embedding's gradient included);
* every gather's fixed-order gradient equals the ``index_select``
  gradient it replaced, on those packagings' own routing: bit for bit
  where a row's readers come in the order the old gradient added them
  (every gather read at most once a row; a token whose K slots rise
  with k), and within K float32 roundings elsewhere.

A CPU run cannot show the card's run-to-run differences themselves;
``tests/test_torch_lm.py``'s ``cuda`` tests and ``chip_smoke.py`` do.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from repro_torch.configs import TRAIN_4K, get_config
from repro_torch.core import dispatch as tdispatch
from repro_torch.core import routing as trouting
from repro_torch.core.dispatch import MeshInfo, moe_dcra
from repro_torch.core.fabric import Fabric
from repro_torch.data.pipeline import synth_batch
from repro_torch.launch import steps as tsteps
from repro_torch.models import moe as tmoe
from repro_torch.models.model_zoo import build_model
from test_torch_moe import CASES, _cfg, _tokens

jax.config.update("jax_platforms", "cpu")


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint16)


# ---------------------------------------------------------------------------
# the combine against segment_sum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 8])
@pytest.mark.parametrize("seed", [0, 1])
def test_combine_equals_segment_sum_bit_for_bit(k, seed):
    """Per shard: ``segment_sum(where(slot >= 0, yb1[slot], 0) * gates,
    src_f, T)`` (``repro/core/dispatch.py:272-275``), with a quarter of
    the tasks dropped, every task of some tokens dropped, -0.0 rows and
    gates, and values whose sums round."""
    rng = np.random.default_rng(seed)
    s, t, d = 3, 37, 6
    n_slots = t * k + 5
    yb1 = (rng.standard_normal((s, n_slots, d))
           * 10.0 ** rng.integers(-3, 4, (s, n_slots, d))).astype(np.float32)
    yb1[rng.random(yb1.shape) < 0.1] = -0.0
    slot = np.stack([rng.permutation(n_slots)[:t * k] for _ in range(s)])
    slot[rng.random(slot.shape) < 0.25] = -1
    slot.reshape(s, t, k)[:, :4] = -1               # tokens all dropped
    slot = slot.astype(np.int32)
    gates = rng.random((s, t * k)).astype(np.float32)
    gates[rng.random(gates.shape) < 0.1] = -0.0
    got = tdispatch.combine(torch.from_numpy(yb1), torch.from_numpy(slot),
                            torch.from_numpy(gates), k).numpy()
    src = np.repeat(np.arange(t, dtype=np.int32), k)
    assert got.shape == (s, t, d)
    for i in range(s):
        task_y = jnp.where(
            jnp.asarray(slot[i] >= 0)[:, None],
            jnp.asarray(yb1[i])[jnp.maximum(jnp.asarray(slot[i]), 0)],
            0.0).astype(jnp.float32)
        want = np.asarray(jax.ops.segment_sum(
            task_y * jnp.asarray(gates[i])[:, None], jnp.asarray(src),
            num_segments=t))
        assert np.array_equal(_bits(got[i]), _bits(want)), i
    assert not np.signbit(got[:, :4]).any()       # dropped tokens: +0.0


def test_sum_k_gradient_is_a_broadcast_view():
    t = torch.randn(2, 5, 3, 4, requires_grad=True)
    out = trouting.sum_k(t)
    g = torch.randn_like(out)
    (gt,) = torch.autograd.grad(out, t, g)
    assert torch.equal(gt, g[:, :, None].expand_as(t))
    want = t.detach()[:, :, 0] + t.detach()[:, :, 1] + t.detach()[:, :, 2]
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# no accumulate-by-index op
# ---------------------------------------------------------------------------

class AccumulateSpy(TorchDispatchMode):
    """Records every aten op that adds into a tensor by index; with
    ``repeats_only``, only a ``scatter_add`` whose index names one target
    twice (one term added onto zero is exact in any order)."""

    def __init__(self, repeats_only=False):
        super().__init__()
        self.seen, self.repeats_only = [], repeats_only

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__.rstrip("_")
        if name == "scatter_add" and self.repeats_only:
            dim, index = args[1], args[2]
            if bool((index.sort(dim).values.diff(dim=dim) == 0).any()):
                self.seen.append(f"{func} with repeated targets")
        elif name in ("index_add", "scatter_add", "index_reduce"):
            self.seen.append(str(func))
        elif name in ("index_put", "_index_put_impl", "put"):
            if kwargs.get("accumulate", len(args) > 3 and args[3]):
                self.seen.append(f"{func} accumulate=True")
        elif name == "scatter_reduce" and kwargs.get(
                "reduce", args[4] if len(args) > 4 else "") in ("sum",
                                                               "mean"):
            self.seen.append(str(func))
        return func(*args, **kwargs)


def _run(name, impl=None, spy=None):
    """``moe_dcra`` of case ``name`` (the reference's weight shapes from
    the port's ``init_moe``), forward and the backward of ``sum(out *
    cot) + aux``, under ``spy``."""
    (shp, names), kw, experts, factor, shape, skew = CASES[name]
    cfg = _cfg(get_config("olmoe-1b-7b").reduced(), experts, factor)
    params = {k: v.requires_grad_(True) for k, v in tmoe.init_moe(
        torch.Generator().manual_seed(experts), cfg).items()}
    x = torch.from_numpy(_tokens(shape, experts, skew)).requires_grad_(True)
    cot = torch.from_numpy(np.random.default_rng(7).standard_normal(
        shape).astype(np.float32))
    info = MeshInfo(Fabric.virtual(shp, names, device="cpu"), **kw)
    queues = dataclasses.replace(tdispatch.dispatch_queues(cfg.moe),
                                 route_impl=impl) if impl else None
    with spy if spy is not None else torch.enable_grad():
        out, aux = moe_dcra(params, x, cfg, info, queues=queues)
        ((out * cot).sum() + aux).backward()
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_moe_dcra_reaches_no_accumulate_by_index(name):
    spy = AccumulateSpy()
    _run(name, spy=spy)
    assert not spy.seen, spy.seen


@pytest.mark.parametrize("impl", ["pallas", "sort", "onehot"])
@pytest.mark.parametrize("name", ["fused_drop", "hier_drop",
                                  "fused_e8_drop"])
def test_every_route_impl_reaches_no_accumulate_by_index(name, impl):
    """Every impl admits the same tasks, so the outputs agree bit for bit
    too."""
    spy = AccumulateSpy()
    out = _run(name, impl, spy)
    assert not spy.seen, spy.seen
    assert torch.equal(out, _run(name, "sort"))


def test_spy_sees_an_accumulating_put():
    """The spy is not blind: advanced indexing's gradient and
    ``index_add_`` are what it flags."""
    spy = AccumulateSpy()
    w = torch.randn(5, 3, requires_grad=True)
    with spy:
        w[torch.tensor([0, 2, 0])].sum().backward()
        torch.zeros(4).index_add_(0, torch.tensor([1, 1]), torch.ones(2))
    assert len(spy.seen) == 2, spy.seen


def test_train_step_reaches_no_accumulate_by_index():
    """A train step of reduced OLMoE-1B-7B through ``moe_dcra`` (the
    embedding's gradient, remat's recompute, AdamW). The loss's
    ``gather`` of each position's label logit has a ``scatter_add`` for
    its gradient, one term a target: exact, so let through."""
    cfg = get_config("olmoe-1b-7b").reduced()
    info = MeshInfo(Fabric.virtual((2, 2, 1), ("data", "expert", "tp"),
                                   device="cpu"))
    model = build_model(cfg, mesh_info=info, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in synth_batch(
        cfg, dataclasses.replace(TRAIN_4K, global_batch=2, seq_len=16), 0,
        seed=0).items()}
    opt = tsteps.default_optimizer()
    step = tsteps.make_train_step(model, opt)
    params = model.paths()
    spy = AccumulateSpy(repeats_only=True)
    with spy:
        _, _, metrics = step(params, opt.init(params), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert not spy.seen, spy.seen


# ---------------------------------------------------------------------------
# the fixed-order gradient against the one it replaced
# ---------------------------------------------------------------------------

class GatherSpy:
    """Within: every ``gather_rows`` call of ``moe_dcra`` that passes an
    inverse, recorded as (table, ids, inverse, k)."""

    def __enter__(self):
        self.calls, self.real = [], tdispatch.gather_rows

        def spy(table, ids, inverse=None, k=1):
            if inverse is not None:
                self.calls.append((table.detach().clone(), ids, inverse, k))
            return self.real(table, ids, inverse, k)
        tdispatch.gather_rows = spy
        return self

    def __exit__(self, *_):
        tdispatch.gather_rows = self.real
        return False


@pytest.mark.parametrize("name", list(CASES))
def test_fixed_order_gradient_equals_the_index_select_gradient(name):
    """Each recorded gather's gradient for a seeded cotangent, through
    its inverse and through ``index_select``'s own backward (which adds
    a row's readers in the order they come in ``ids``): bit for bit at
    every row whose readers come in k order, within K float32 roundings
    of the terms' sum elsewhere. The dispatch gather (k = top_k) reads a
    token once a kept task; the rest read a row at most once."""
    with GatherSpy() as seen:
        _run(name)
    ks = sorted({c[3] for c in seen.calls})
    assert ks[0] == 1 and ks[-1] == get_config(
        "olmoe-1b-7b").reduced().moe.top_k
    rng = np.random.default_rng(3)
    for table, ids, inverse, k in seen.calls:
        g = torch.from_numpy(rng.standard_normal(
            (*ids.shape, table.shape[2])).astype(np.float32))
        old_t = table.clone().requires_grad_(True)
        (old,) = torch.autograd.grad(trouting._gather(old_t, ids), old_t, g)
        new_t = table.clone().requires_grad_(True)
        (new,) = torch.autograd.grad(
            trouting.gather_rows(new_t, ids, inverse, k), new_t, g)
        by_k = inverse.view(inverse.shape[0], -1, k).long()
        kept = by_k.masked_fill(by_k < 0, 1 << 40)
        in_order = (kept[..., 1:] >= kept[..., :-1]).all(-1)
        if k == 1:
            assert bool(in_order.all())
        assert torch.equal(new[in_order].view(-1).view(torch.int32),
                           old[in_order].view(-1).view(torch.int32))
        terms = trouting._gather(g.abs(), by_k.view(by_k.shape[0], -1)
                                 ).view(*by_k.shape, -1).sum(2)
        tol = k * 2.0 ** -24 * terms
        assert bool(((new - old).abs() <= tol).all())
