"""The port's MoE layer against the JAX package, on the CPU.

Part A — in-process: the config copy, the dispatch queue sizing, the
fabric's shard_map helpers, ``gather_rows`` / ``slot_scatter`` and the
half-width wire against the reference's functions, and ``moe_einsum``
on reduced OLMoE-1B-7B with the reference's ``init_moe`` weights carried
across as numpy.

Part B — one module-scoped subprocess runs the reference on 8 fake host
devices: the virtual collectives against ``lax.all_to_all`` /
``all_gather`` / ``psum`` over single axes and axis tuples, and
``moe_dcra`` in the packagings of ``tests/test_dispatch.py`` (fused tp,
tp-sharded FFN, two-stage over pods), with more experts so a shard owns
two, with a seq length that does not split over the group (the
``do_slice`` and ``tp_gather`` branches), at capacity factor 8 (no drop)
and 1.25 on skewed tokens (where capped buckets drop). A spy around
the reference's ``_bucket`` records each bucket's destinations and
admitted slots per shard, so the port is held to the reference's top-k
ids and its admitted and dropped counts per bucket exactly, and to its
output within 1e-5 of max|out|.
"""
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.core import queues as jq
from repro.core import routing as jrouting
from repro.models import moe as jmoe
from repro_torch.configs import get_config
from repro_torch.core import queues as tq
from repro_torch.core import routing as trouting
from repro_torch.core.dispatch import MeshInfo, moe_dcra
from repro_torch.core.fabric import Fabric
from repro_torch.models import moe as tmoe

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
D_MODEL = 64


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _cfg(arch_cfg, experts, factor):
    return dataclasses.replace(arch_cfg, moe=dataclasses.replace(
        arch_cfg.moe, num_experts=experts, capacity_factor=factor))


def _tokens(shape, seed, skew):
    """Seeded tokens; ``skew`` adds one shared direction to every token,
    so the router favours some experts and capped buckets drop."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) + skew * rng.standard_normal(shape[-1])
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# Part A
# ---------------------------------------------------------------------------

def test_config_copy_matches_reference():
    want = j_get_config("olmoe-1b-7b")
    got = get_config("olmoe-1b-7b")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(
        want.reduced())
    for a, b in ((got, want), (got.reduced(), want.reduced())):
        assert a.param_count() == b.param_count()
        assert a.active_param_count() == b.active_param_count()
        assert a.resolved_head_dim == b.resolved_head_dim


def test_unported_arch_ids_raise():
    """Every arch id the reference knows resolves (the recurrent one
    too); an id it does not know raises, naming the known ones."""
    assert get_config("rwkv6-7b").family == "ssm"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(KeyError, match="olmoe-1b-7b"):
        get_config("olmoe")


@pytest.mark.parametrize("factor", [1.25, 2.0, 8.0, 0.3])
def test_moe_dispatch_caps_match_reference(factor):
    want = jq.QueueConfig.for_moe_dispatch(factor)
    got = tq.QueueConfig.for_moe_dispatch(factor)
    assert tq.MOE_DISPATCH_TASKS == jq.MOE_DISPATCH_TASKS
    for task in tq.MOE_DISPATCH_TASKS:
        for tasks, chans in ((16, 4), (8192, 8), (10240, 2), (12800, 4),
                             (7, 3), (131072, 64)):
            assert (got.channel_cap(task, tasks, chans)
                    == want.channel_cap(task, tasks, chans))


def test_fabric_shard_helpers():
    """``shard`` / ``unshard`` invert each other under the dispatch's
    specs, ``all_gather`` then ``shard_slice`` is the identity, and the
    linear index over an axis tuple is row-major in the tuple's order."""
    fab = Fabric.virtual((2, 2, 2), ("data", "expert", "tp"), device="cpu")
    assert fab.axis_size(None) == 1 and fab.axis_size(("expert", "tp")) == 4
    assert fab.axis_index(("tp", "expert")).tolist() == [0, 2, 1, 3] * 2
    x = torch.arange(4 * 8 * 3, dtype=torch.float32).view(4, 8, 3)
    for spec in (("data", ("expert", "tp"), None), ("data", "tp", None),
                 (None, None, None), (("data", "expert"), "tp", None)):
        xs = fab.shard(x, spec)
        assert torch.equal(fab.unshard(xs, spec), x), spec
    xs = fab.shard(x, ("data", "tp"))
    for axes in ("tp", ("expert", "tp"), ("tp", "expert")):
        g = fab.all_gather(xs, axes, 1)
        assert g.shape[2] == xs.shape[2] * fab.axis_size(axes)
        assert torch.equal(fab.shard_slice(g, axes, 1), xs), axes
    with pytest.raises(ValueError, match="no axis"):
        fab.axis_size("pod")
    with pytest.raises(ValueError, match="does not split"):
        fab.shard(x[:3], ("data",))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gather_rows_and_slot_scatter_match_reference(seed):
    """Exact, shard by shard: -1 ids gather zero rows; at most one valid
    row a slot, empty slots 0."""
    rng = np.random.default_rng(seed)
    s, m, d, r = 3, 37, 5, 53
    table = rng.standard_normal((s, m, d)).astype(np.float32)
    ids = rng.integers(-1, m, (s, r)).astype(np.int32)
    got = trouting.gather_rows(_t(table), _t(ids)).numpy()
    n_slots = 41
    slot = np.stack([rng.permutation(n_slots + 12)[:r] for _ in range(s)]
                    ).astype(np.int32)
    valid = (slot < n_slots) & (rng.random((s, r)) < 0.8)
    data = rng.standard_normal((s, r, d)).astype(np.float32)
    sc = trouting.slot_scatter(_t(data), _t(slot), _t(valid), n_slots).numpy()
    for i in range(s):
        want = np.asarray(jrouting.gather_rows(jnp.asarray(table[i]),
                                               jnp.asarray(ids[i])))
        assert np.array_equal(got[i], want)
        want = np.asarray(jrouting.slot_scatter(
            jnp.asarray(data[i]), jnp.asarray(slot[i]), jnp.asarray(valid[i]),
            n_slots))
        assert np.array_equal(sc[i], want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d", [1, 6, 7])
def test_half_width_wire_matches_reference_bytes(dtype, d):
    """Half-width payloads go two to a float32 lane (an odd width padded),
    ints bitcast: the packed wire is byte for byte the reference's, and
    the round trip is exact."""
    rng = np.random.default_rng(d)
    vals32 = (rng.standard_normal((2, 9, d)) * 100).astype(np.float32)
    tv = _t(vals32).to(getattr(torch, dtype))
    jv = jnp.asarray(vals32).astype(getattr(jnp, dtype))
    ints = [rng.integers(-1, 1 << 30, (2, 9)).astype(np.int32)
            for _ in range(2)]
    packed, meta = trouting.pack_wire(tv, [_t(a) for a in ints])
    width = (d + 1) // 2 if dtype != "float32" else d
    assert packed.dtype == torch.float32 and packed.shape == (2, 9, width + 2)
    for s in range(2):
        jp, jmeta = jrouting.pack_wire(jv[s], [jnp.asarray(a[s]) for a in ints])
        assert packed[s].numpy().tobytes() == np.asarray(jp).tobytes()
    back, back_ints = trouting.unpack_wire(packed, meta)
    assert back.dtype == tv.dtype
    assert back.view(torch.uint8).numpy().tobytes() == \
        tv.contiguous().view(torch.uint8).numpy().tobytes()
    assert all(np.array_equal(b.numpy(), a) for a, b in zip(ints, back_ints))


def test_wire_refuses_other_payload_types():
    with pytest.raises(TypeError, match="wire payloads"):
        trouting.pack_wire(torch.zeros(2, 3, 1, dtype=torch.float64), [])


@pytest.mark.parametrize("experts,factor,shape", [
    (4, 8.0, (4, 16, D_MODEL)), (4, 1.25, (4, 64, D_MODEL)),
    (8, 1.25, (2, 1024, D_MODEL)), (4, 2.0, (3, 6, D_MODEL))])
def test_moe_einsum_matches_reference(experts, factor, shape):
    """Reduced OLMoE, the reference's ``init_moe`` weights carried across:
    the routing agrees exactly (top-k ids, queue positions), the output
    within 1e-5 of max|out| (float32 einsums in another order) and the
    aux loss within 1e-6 relative."""
    cfg_j = _cfg(j_get_config("olmoe-1b-7b").reduced(), experts, factor)
    cfg_t = _cfg(get_config("olmoe-1b-7b").reduced(), experts, factor)
    params = {k: np.asarray(v) for k, v in
              jmoe.init_moe(jax.random.key(experts), cfg_j).items()}
    x = _tokens(shape, experts, 1.0)
    want, want_aux = jmoe.moe_einsum(params, jnp.asarray(x), cfg_j)
    tp = tmoe.moe_params_from_numpy(params, device="cpu")
    got, got_aux = tmoe.moe_einsum(tp, _t(x), cfg_t)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.max(np.abs(got.numpy() - want)) <= 1e-5 * np.max(np.abs(want))
    assert abs(float(got_aux) - float(want_aux)) <= 1e-6 * abs(float(want_aux))
    # the routing underneath: probabilities, top-k ids and capacity
    xg = x.reshape(1, -1, shape[-1])
    jp, _ = jmoe.router_probs(params, jnp.asarray(xg), cfg_j.moe)
    tp_probs, _ = tmoe.router_probs(tp, _t(xg), cfg_t.moe)
    jg, joh = jmoe._topk_mask(jp, cfg_j.moe.top_k)
    tg, toh = tmoe._topk_mask(tp_probs, cfg_t.moe.top_k)
    assert np.array_equal(toh.numpy(), np.asarray(joh))
    assert np.allclose(tg.numpy(), np.asarray(jg), rtol=1e-6, atol=0)
    for n in (1, 16, 1000, 1024):
        assert tmoe.capacity(n, cfg_t.moe) == jmoe.capacity(n, cfg_j.moe)


def test_topk_breaks_ties_to_the_lower_index():
    probs = torch.tensor([[0.2, 0.3, 0.3, 0.2], [0.25, 0.25, 0.25, 0.25]])
    vals, idx = tmoe.topk(probs, 3)
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert idx.tolist() == np.asarray(ji).tolist() == [[1, 2, 0], [0, 1, 2]]
    assert np.array_equal(vals.numpy(), np.asarray(jv))


def test_moe_block_dispatches_by_config():
    cfg = _cfg(get_config("olmoe-1b-7b").reduced(), 4, 8.0)
    params = tmoe.init_moe(torch.Generator().manual_seed(0), cfg)
    x = _t(_tokens((4, 16, D_MODEL), 0, 0.0))
    fab = Fabric.virtual((2, 2, 2), ("data", "expert", "tp"), device="cpu")
    out_e, _ = tmoe.moe_block(params, x, cfg)
    out_d, _ = tmoe.moe_block(params, x, cfg, MeshInfo(fab))
    assert torch.equal(out_e, tmoe.moe_einsum(params, x, cfg)[0])
    assert float((out_d - out_e).abs().max()) <= 1e-5 * float(
        out_e.abs().max())
    with pytest.raises(TypeError, match="Fabric"):
        MeshInfo(object())


# ---------------------------------------------------------------------------
# Part B — the reference on 8 fake devices
# ---------------------------------------------------------------------------

FLAT = ((2, 2, 2), ("data", "expert", "tp"))
PODS = ((2, 1, 2, 2), ("pod", "data", "expert", "tp"))
# name -> (fabric, MeshInfo kwargs, experts, capacity factor, x shape, skew)
CASES = {
    "fused": (FLAT, {}, 4, 8.0, (4, 16, D_MODEL), 0.0),
    "tp_ffn": (FLAT, {"fuse_tp": False}, 4, 8.0, (4, 16, D_MODEL), 0.0),
    "hier": (PODS, {"pod_axis": "pod"}, 8, 8.0, (4, 16, D_MODEL), 0.0),
    "fused_e8": (FLAT, {}, 8, 8.0, (4, 16, D_MODEL), 0.0),
    "hier_e16": (PODS, {"pod_axis": "pod"}, 16, 8.0, (4, 16, D_MODEL), 0.0),
    "fused_seq6": (FLAT, {}, 4, 8.0, (4, 6, D_MODEL), 0.0),
    "tp_ffn_seq6": (FLAT, {"fuse_tp": False}, 4, 8.0, (4, 6, D_MODEL), 0.0),
    "fused_drop": (FLAT, {}, 4, 1.25, (4, 64, D_MODEL), 1.0),
    "tp_ffn_drop": (FLAT, {"fuse_tp": False}, 4, 1.25, (4, 64, D_MODEL), 1.0),
    "hier_drop": (PODS, {"pod_axis": "pod"}, 8, 1.25, (4, 64, D_MODEL), 1.0),
    "fused_e8_drop": (FLAT, {}, 8, 1.25, (4, 64, D_MODEL), 1.0),
    "hier_e16_drop": (PODS, {"pod_axis": "pod"}, 16, 1.25, (4, 64, D_MODEL),
                      1.0),
}

SCRIPT = r"""
import os
os.environ['XLA_FLAGS'] = '--xla_force_host_platform_device_count=8'
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.core import dispatch as jd
from repro.core.compat import make_mesh, set_mesh, shard_map_unchecked
from repro.models.moe import init_moe

out_path, cases = sys.argv[1], json.loads(sys.argv[2])
res = {}

# the collectives over one axis and over axis tuples
mesh = make_mesh((2, 2, 2), ('data', 'expert', 'tp'))
AX = ('data', 'expert', 'tp')
a = np.arange(8 * 8 * 3, dtype=np.float32).reshape(64, 3)
def run(body):
    f = shard_map_unchecked(body, mesh=mesh, in_specs=(P(AX, None),),
                            out_specs=P(AX, None))
    with set_mesh(mesh):
        return np.asarray(jax.jit(f)(jnp.asarray(a)))
for axes in (('expert', 'tp'), ('tp', 'expert'), ('tp',), ('data', 'tp')):
    res['a2a_' + '_'.join(axes)] = run(
        lambda x: jax.lax.all_to_all(x, axes, 0, 0, tiled=True))
    res['gather_' + '_'.join(axes)] = run(
        lambda x: jax.lax.all_gather(x, axes, axis=0, tiled=True)[:8])
    res['psum_' + '_'.join(axes)] = run(lambda x: jax.lax.psum(x, axes))

REC, TRACE, AXES = [], [], [None]
orig = jd._bucket
def spy(x_tasks, dest, valid, aux_ints, n_buckets, cap, impl=None):
    out = orig(x_tasks, dest, valid, aux_ints, n_buckets, cap, impl=impl)
    stage = len(TRACE)
    TRACE.append(stage)
    def rec(g, d, v, s, *aux):
        REC.append((stage, int(g), np.asarray(d), np.asarray(v),
                    np.asarray(s), [np.asarray(c) for c in aux]))
    jax.debug.callback(rec, jax.lax.axis_index(AXES[0]), dest, valid,
                       out[2], *aux_ints)
    return out
jd._bucket = spy

base = get_config('olmoe-1b-7b').reduced()
plans = {}
for name, (fabric, kw, experts, factor, shape, skew) in cases.items():
    shp, names = fabric
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, num_experts=experts, capacity_factor=factor))
    params = init_moe(jax.random.key(experts), cfg)
    rng = np.random.default_rng(sum(shape) + experts)
    x = rng.standard_normal(shape) + skew * rng.standard_normal(shape[-1])
    x = jnp.asarray(x.astype(np.float32))
    mesh = make_mesh(tuple(shp), tuple(names))
    AXES[0] = mesh.axis_names
    info = jd.MeshInfo(mesh, **kw)
    plans[name] = [list(p) if isinstance(p, tuple) else p
                   for p in info.dispatch_plan(experts)]
    REC.clear()
    TRACE.clear()
    with set_mesh(mesh):
        out, aux = jax.jit(lambda p, x: jd.moe_dcra(p, x, cfg, info))(
            params, x)
        out = np.asarray(out)
    for k, v in params.items():
        res[f'{name}/param/{k}'] = np.asarray(v)
    res[f'{name}/out'] = out
    res[f'{name}/aux'] = np.asarray(aux)
    for stage in sorted({r[0] for r in REC}):
        rows = sorted((r for r in REC if r[0] == stage), key=lambda r: r[1])
        assert [r[1] for r in rows] == list(range(mesh.devices.size))
        for j, key in enumerate(('dest', 'valid', 'slot')):
            res[f'{name}/{stage}/{key}'] = np.stack([r[2 + j] for r in rows])
        for c in range(len(rows[0][5])):
            res[f'{name}/{stage}/aux{c}'] = np.stack([r[5][c] for r in rows])
# gradients: jax.grad of sum(out * cot) and of aux, through shard_map
for name in json.loads(sys.argv[3]):
    (shp, names), kw, experts, factor, shape, skew = cases[name]
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, num_experts=experts, capacity_factor=factor))
    params = init_moe(jax.random.key(experts), cfg)
    rng = np.random.default_rng(sum(shape) + experts)
    x = rng.standard_normal(shape) + skew * rng.standard_normal(shape[-1])
    x = jnp.asarray(x.astype(np.float32))
    cot = np.random.default_rng(99 + experts).standard_normal(shape).astype(
        np.float32)
    mesh = make_mesh(tuple(shp), tuple(names))
    AXES[0] = mesh.axis_names
    info = jd.MeshInfo(mesh, **kw)
    parts = {'out': lambda p, x: jnp.sum(jd.moe_dcra(p, x, cfg, info)[0]
                                          * cot),
             'aux': lambda p, x: jd.moe_dcra(p, x, cfg, info)[1]}
    res[f'{name}/cot'] = cot
    with set_mesh(mesh):
        for part, f in parts.items():
            gp, gx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, x)
            for k, v in gp.items():
                res[f'{name}/grad_{part}/{k}'] = np.asarray(v)
            res[f'{name}/grad_{part}/x'] = np.asarray(gx)
np.savez(out_path, **res)
print('PLANS ' + json.dumps(plans))
"""

#: the cases whose gradients the reference computes: fused, tp-sharded
#: FFN and two-stage (the (2, 1, 2, 2) pod fabric), tokens replicated
#: over the expert axis (seq 6: ``do_slice``, ``tp_gather``), a shard
#: owning two experts, and the two-stage path where capped buckets drop
GRAD_CASES = ("fused", "tp_ffn", "hier", "fused_e8", "fused_seq6",
              "tp_ffn_seq6", "hier_drop")


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe") / "ref.npz")
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, path, json.dumps(CASES),
         json.dumps(GRAD_CASES)], env=env,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("PLANS ")]
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    return json.loads(line[0][len("PLANS "):]), arrays


@pytest.mark.parametrize("axes", [("expert", "tp"), ("tp", "expert"),
                                  ("tp",), ("data", "tp")])
def test_virtual_collectives_match_reference(reference, axes):
    """all_to_all, tiled all_gather and psum over an axis or a tuple of
    axes deliver what the reference's collectives do, shard by shard."""
    _, ref = reference
    fab = Fabric.virtual(*FLAT, device="cpu")
    x = torch.arange(8 * 8 * 3, dtype=torch.float32).view(8, 8, 3)
    tag = "_".join(axes)
    got = trouting.noc_all_to_all(x, fab.shape, fab.axis_dims(axes))
    assert np.array_equal(got.reshape(64, 3).numpy(), ref["a2a_" + tag])
    got = fab.all_gather(x, axes, 0)[:, :8]
    assert np.array_equal(got.reshape(64, 3).numpy(), ref["gather_" + tag])
    got = fab.psum(x, axes)
    assert np.array_equal(got.reshape(64, 3).numpy(), ref["psum_" + tag])


def _port_run(name, ref):
    (shp, names), kw, experts, factor, shape, skew = CASES[name]
    cfg = _cfg(get_config("olmoe-1b-7b").reduced(), experts, factor)
    params = tmoe.moe_params_from_numpy(
        {k: ref[f"{name}/param/{k}"] for k in ("router", "wg", "wu", "wd")},
        device="cpu")
    rng = np.random.default_rng(sum(shape) + experts)
    x = rng.standard_normal(shape) + skew * rng.standard_normal(shape[-1])
    info = MeshInfo(Fabric.virtual(shp, names, device="cpu"), **kw)
    out, aux, stats = moe_dcra(params, _t(x.astype(np.float32)), cfg, info,
                               return_stats=True)
    return info, params, _t(x.astype(np.float32)), cfg, out, aux, stats


STAGES = ("dispatch", "portal", "expert")


def _ref_stages(name, ref):
    n = sum(1 for k in ref if k.startswith(f"{name}/") and k.endswith("/dest"))
    return [{key: ref[f"{name}/{i}/{key}"] for key in ("dest", "valid",
                                                       "slot")}
            | {"aux": [ref[f"{name}/{i}/aux{c}"] for c in range(3)
                       if f"{name}/{i}/aux{c}" in ref]}
            for i in range(n)]


@pytest.mark.parametrize("name", list(CASES))
def test_dispatch_plan_and_topk_match_reference(reference, name):
    """The same dispatch plan, and the top-k ids of every task, in order,
    exactly (rebuilt from the reference's first bucket: owner and local
    id, or intra-pod owner, pod and local id)."""
    plans, ref = reference
    info, _, x, cfg, _, _, stats = _port_run(name, ref)
    group, spans, tp_ffn = info.dispatch_plan(cfg.moe.num_experts)
    assert [list(group), spans, tp_ffn] == plans[name]
    n_ex = info.axis_size(group)
    e_local = cfg.moe.num_experts // (
        n_ex * (info.axis_size(info.pod_axis) if spans else 1))
    first = _ref_stages(name, ref)[0]
    if spans:
        want = (first["aux"][0] * n_ex + first["dest"]) * e_local \
            + first["aux"][1]
    else:
        want = first["dest"] * e_local + first["aux"][0]
    got = stats.topk_ids.reshape(want.shape).numpy()
    if not np.array_equal(got, want):
        p = torch.sort(torch.softmax(
            x.reshape(-1, x.shape[-1]) @ torch.from_numpy(
                ref[f"{name}/param/router"]), -1), -1, descending=True)[0]
        k = cfg.moe.top_k
        margin = float((p[:, k - 1] - p[:, k]).min())
        pytest.fail(f"{int((got != want).sum())} top-k ids differ; smallest "
                    f"router margin between rank {k} and {k + 1}: {margin}")


@pytest.mark.parametrize("name", list(CASES))
def test_bucket_admission_matches_reference(reference, name):
    """Per shard and bucket, admitted and dropped counts of every bucket
    stage equal the reference's; capacity 1.25 drops, 8 does not."""
    _, ref = reference
    *_, stats = _port_run(name, ref)
    stages = _ref_stages(name, ref)
    assert len(stages) == len(stats.buckets)
    dropped = 0
    for stage_name, want in zip([s for s in STAGES if s in stats.buckets],
                                stages):
        admitted, drops = stats.buckets[stage_name]
        nb = admitted.shape[1]
        kept = want["valid"] & (want["slot"] >= 0)
        lost = want["valid"] & (want["slot"] < 0)
        for s in range(admitted.shape[0]):
            d = np.clip(want["dest"][s], 0, nb - 1)
            assert np.array_equal(admitted[s].numpy(), np.bincount(
                d[kept[s]], minlength=nb)), (stage_name, s)
            assert np.array_equal(drops[s].numpy(), np.bincount(
                d[lost[s]], minlength=nb)), (stage_name, s)
        dropped += int(drops.sum())
    assert dropped == stats.total_dropped
    if CASES[name][3] < 2.0:
        assert dropped > 0
    else:
        assert dropped == 0


@pytest.mark.parametrize("name", list(CASES))
def test_moe_dcra_matches_reference(reference, name):
    """The output within 1e-5 of max|out| of the reference's (float32
    matmuls and the gate-weighted combine summed in another order), the
    aux loss within 1e-6 relative; at capacity factor 8 both equal the
    port's einsum oracle within the same bound."""
    _, ref = reference
    _, params, x, cfg, out, aux, _ = _port_run(name, ref)
    want = ref[f"{name}/out"]
    scale = np.max(np.abs(want))
    assert out.shape == want.shape
    assert np.max(np.abs(out.numpy() - want)) <= 1e-5 * scale
    assert abs(float(aux) - float(ref[f"{name}/aux"])) <= 1e-6 * abs(
        float(ref[f"{name}/aux"]))
    if CASES[name][3] >= 8.0:
        oracle, _ = tmoe.moe_einsum(params, x, cfg)
        assert float((out - oracle).abs().max()) <= 1e-5 * scale


GRAD_KEYS = ("router", "wg", "wu", "wd", "x")


@pytest.mark.parametrize("name", GRAD_CASES)
def test_moe_dcra_gradients_match_einsum_and_reference(reference, name):
    """Autograd through ``moe_dcra`` (the shard copies, ``gather_rows``'
    in-place mask, the wire's transposes, ``slot_scatter``, the
    combine's in-order sum, the casts): the gradients of ``sum(out * cot)`` with
    respect to the router, ``wg``/``wu``/``wd`` and ``x``, and of the aux
    loss with respect to the router and ``x``, each within 1e-5 of its
    max|g| of the reference's ``jax.grad`` through ``shard_map``. Without
    drops (factor 8) the output part is also the port's ``moe_einsum``
    gradient within the same bound: the function's true gradient. The
    reference's gradients are the true ones on every packaging here:
    no replicated input or output of its unchecked ``shard_map``
    transposes to a multiple."""
    _, ref = reference
    (shp, names), kw, experts, factor, shape, skew = CASES[name]
    cfg = _cfg(get_config("olmoe-1b-7b").reduced(), experts, factor)
    params = {k: _t(ref[f"{name}/param/{k}"]).requires_grad_(True)
              for k in ("router", "wg", "wu", "wd")}
    rng = np.random.default_rng(sum(shape) + experts)
    x = rng.standard_normal(shape) + skew * rng.standard_normal(shape[-1])
    x = _t(x.astype(np.float32)).requires_grad_(True)
    cot = _t(ref[f"{name}/cot"])
    info = MeshInfo(Fabric.virtual(shp, names, device="cpu"), **kw)
    out, aux = moe_dcra(params, x, cfg, info)
    leaves = [params[k] for k in GRAD_KEYS[:-1]] + [x]
    got = dict(zip(GRAD_KEYS, torch.autograd.grad((out * cot).sum(), leaves,
                                                  retain_graph=True)))
    got_aux = dict(zip(("router", "x"), torch.autograd.grad(
        aux, [params["router"], x])))

    def held(g, want, what):
        tol = 1e-5 * float(np.abs(want).max())
        assert float(np.abs(g.numpy() - want).max()) <= tol, what
    for k in GRAD_KEYS:
        held(got[k], ref[f"{name}/grad_out/{k}"], ("out", k))
    for k in ("router", "x"):
        held(got_aux[k], ref[f"{name}/grad_aux/{k}"], ("aux", k))
    for k in ("wg", "wu", "wd"):       # the aux loss reads only the router
        assert not ref[f"{name}/grad_aux/{k}"].any()
    if factor >= 8.0:
        eout, _ = tmoe.moe_einsum(params, x, cfg)
        want = torch.autograd.grad((eout * cot).sum(), leaves)
        for k, w in zip(GRAD_KEYS, want):
            held(got[k], w.numpy(), ("einsum", k))
