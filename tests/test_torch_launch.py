"""The port's LM launch runtime and analytic dry run against the JAX
package, on the CPU (``repro_torch.launch.{mesh,sharding,analytic,
roofline,report,dryrun,hillclimb}``):

* ``forward_flops``, ``step_cost`` and ``model_flops`` equal to the
  reference's (``==``) for the ten archs x four shapes, and for the
  ``dispatch_impl="einsum"``, ``capacity_factor=1.0`` and
  ``remat="none"`` variants;
* the counterparts of ``tests/test_roofline.py``'s parser,
  ``test_analytic_costs_sane`` and
  ``test_moe_capacity_padding_shows_in_flops``;
* ``report.summary`` / ``roofline_table`` give the reference's text on
  the same records ("—" for the port's ``None`` terms);
* the fabrics of the mesh factories, ``mesh_info_for``, ``model_axes``,
  ``batch_axes``, and the spec tables (parameters with ``fsdp`` True and
  False, batches, caches, ``logical_rules``) equal to the reference's
  for every arch on the single and multi fabrics, the reference's
  leading layer entry dropped (one JAX subprocess on 512 host devices,
  which also reads the reference's ``hillclimb.VARIANTS``: importing
  ``repro.launch.dryrun`` or ``hillclimb`` sets ``XLA_FLAGS``);
* every full-size arch built on the meta device, drawing nothing;
* ``dryrun --measure --device cpu`` on a reduced arch writing every
  key, and ``make_train_step`` checking its shape against the rules.
"""
import ast
import dataclasses
import json
import os
import subprocess
import sys
import tracemalloc

import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import analytic as janalytic
from repro.launch import report as jreport
from repro.launch import roofline as jroofline
from repro_torch.configs import ARCH_IDS, SHAPES, ShapeConfig, get_config
from repro_torch.launch import analytic, dryrun, hillclimb, mesh, report
from repro_torch.launch import roofline, sharding, steps
from repro_torch.models import common
from repro_torch.models.model_zoo import build_model

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
VARIANTS = [{}, {"dispatch_impl": "einsum"}, {"capacity_factor": 1.0},
            {"remat": "none"}]


def _variant(cfg, kw):
    if "remat" in kw:
        return dataclasses.replace(cfg, remat=kw["remat"])
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw))


# ---------------------------------------------------------------------------
# analytic counts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_analytic_counts_equal_the_reference(arch):
    """Every shape (applicable or not: the formulas take any) and every
    variant, exactly."""
    for kw in VARIANTS:
        jc, tc = _variant(jget(arch), kw), _variant(get_config(arch), kw)
        for name in SHAPES:
            js, ts = JSHAPES[name], SHAPES[name]
            want, got = janalytic.step_cost(jc, js), analytic.step_cost(tc, ts)
            assert (got.flops, got.hbm_bytes) == (want.flops, want.hbm_bytes)
            for decode in (False, True):
                assert analytic.forward_flops(
                    tc, ts.global_batch, ts.seq_len, decode) == \
                    janalytic.forward_flops(jc, js.global_batch, js.seq_len,
                                            decode)
            assert roofline.model_flops(tc, ts) == \
                jroofline.model_flops(jc, js)


HLO = """
  %ag = f32[8,128]{1,0} all-gather(%x), replica_groups={{0,1}}
  %ar = bf16[16]{0} all-reduce(%y), to_apply=%add
  %a2a = (f32[4,4]{1,0}, f32[4,4]{1,0}) all-to-all(%a, %b)
  %cp = u8[32]{0} collective-permute(%z)
  %dot = f32[999]{0} dot(%p, %q)
"""


def test_collective_parser_counts_result_bytes():
    out = roofline.collective_bytes(HLO)
    assert out["all-gather"] == 8 * 128 * 4
    assert out["all-reduce"] == 16 * 2 * 2          # x2: RS+AG phases
    assert out["all-to-all"] == 2 * 4 * 4 * 4
    assert out["collective-permute"] == 32
    assert "dot" not in out
    assert out == jroofline.collective_bytes(HLO)


def test_shape_bytes_tuple():
    for s in ("(f32[2,3]{1,0}, s8[5]{0})", "bf16[]", "pred[7] token[]"):
        assert roofline._shape_bytes(s) == jroofline._shape_bytes(s)
    assert roofline._shape_bytes("(f32[2,3]{1,0}, s8[5]{0})") == 2 * 3 * 4 + 5


@pytest.mark.parametrize("arch", ["granite-8b", "mixtral-8x22b", "rwkv6-7b",
                                  "zamba2-7b", "seamless-m4t-large-v2"])
def test_analytic_costs_sane(arch):
    cfg = get_config(arch)
    tr = analytic.step_cost(cfg, SHAPES["train_4k"])
    pf = analytic.step_cost(cfg, SHAPES["prefill_32k"])
    dc = analytic.step_cost(cfg, SHAPES["decode_32k"])
    assert tr.flops > 0 and tr.hbm_bytes > 0
    assert tr.flops > 2.0 * pf.flops
    assert dc.flops < pf.flops / 100
    floor = 6.0 * cfg.active_param_count() * 256 * 4096
    lo = 0.5 if cfg.family == "encdec" else 0.8
    assert lo * floor < tr.flops < 6 * floor


def test_moe_capacity_padding_shows_in_flops():
    cfg = get_config("mixtral-8x22b")
    cfg_e = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, dispatch_impl="einsum"))
    assert analytic.forward_flops(cfg_e, 8, 4096) > \
        analytic.forward_flops(cfg, 8, 4096) * 1.1


def test_roofline_on_h100_figures_has_no_collective_term():
    cfg, shape = get_config("granite-8b"), SHAPES["train_4k"]
    rl = roofline.analyze(cfg, shape, chips=256, measured_s=2.0)
    est = analytic.step_cost(cfg, shape)
    assert rl.compute_s == est.flops / 256 / 989e12
    assert rl.memory_s == est.hbm_bytes / 256 / 3.35e12
    assert rl.collective_s is None
    assert rl.notes["collective"] == roofline.NO_HLO
    assert rl.bottleneck == "compute"
    assert rl.share_of_measured() == {"compute": rl.compute_s / 2.0,
                                      "memory": rl.memory_s / 2.0}
    assert (roofline.H100_PEAK_BF16_FLOPS, roofline.H100_PEAK_F32_FLOPS,
            roofline.H100_HBM_BW, roofline.H100_NVLINK_BW) == (
        989e12, 67e12, 3.35e12, 450e9)


def test_the_port_carries_no_tpu_constant():
    src = os.path.join(SRC, "repro_torch")
    for dirpath, _, files in os.walk(src):
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(dirpath, f)).read()
                assert "TPU_" not in text and "197e12" not in text, f


# ---------------------------------------------------------------------------
# report
# ---------------------------------------------------------------------------

def _records():
    rng = np.random.default_rng(0)
    out = []
    for arch in ("granite-8b", "zamba2-7b", "olmoe-1b-7b"):
        for shape in ("decode_32k", "train_4k", "long_500k", "prefill_32k"):
            for m in ("single", "multi"):
                c, mm, n = rng.random(3) * 10.0 ** rng.integers(-6, 1, 3)
                out.append({"arch": arch, "shape": shape, "mesh": m,
                            "tag": "", "compute_s": c, "memory_s": mm,
                            "collective_s": n,
                            "bottleneck": max(
                                {"compute": c, "memory": mm,
                                 "collective": n}.items(),
                                key=lambda kv: kv[1])[0],
                            "model_flops_ratio": rng.random(),
                            "temp_size_in_bytes": int(rng.integers(1 << 34))})
    out[3] = {"arch": "zamba2-7b", "shape": "long_500k", "mesh": "single",
              "skipped": "shape not applicable (DESIGN.md §5)"}
    out[5] = {"arch": "olmoe-1b-7b", "shape": "train_4k", "mesh": "multi",
              "error": "ValueError: x"}
    out.append(dict(out[0], tag="A1-serve-nofsdp"))
    return out


def test_report_text_equals_the_reference():
    recs = _records()
    assert report.summary(recs) == jreport.summary(recs)
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    assert report.summary([]) == jreport.summary([])


def test_report_prints_a_dash_for_the_terms_the_port_lacks():
    rec = dryrun.lower_cell("qwen2-1.5b", "decode_32k", False, verbose=False)
    text = report.roofline_table([rec])
    row = text.splitlines()[-1]
    cells = [c.strip() for c in row.strip("|").split("|")]
    assert cells[5] == "—" and cells[8] == "—"
    assert cells[3] == f"{rec['compute_s']:.2e}"
    assert report.summary([rec]).endswith("max temp/device — GiB")


# ---------------------------------------------------------------------------
# mesh and sharding against the reference (one subprocess)
# ---------------------------------------------------------------------------

REF = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import json
import jax, jax.numpy as jnp
from repro.configs import ARCH_IDS, get_config
from repro.launch import mesh as jmesh, sharding as jsh
from repro.launch.hillclimb import VARIANTS
from repro.models.model_zoo import build_model


def spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


def plain(v):
    return list(v) if isinstance(v, tuple) else v


def keyname(k):
    return str(getattr(k, "key", getattr(k, "name", getattr(k, "idx", k))))


def flat(tree, fn):
    return {"/".join(keyname(k) for k in path): fn(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


res = {"variants": [[c, list(cell), tag, {k: repr(v) for k, v in kw.items()},
                     h] for c, cell, tag, kw, h in VARIANTS], "archs": {}}
for arch in ARCH_IDS:
    cfg = get_config(arch)
    model = build_model(cfg, dtype=jnp.bfloat16)
    pshape = jax.eval_shape(model.init, jax.random.key(0))
    ra = res["archs"][arch] = {}
    for mp in (False, True):
        mesh = jmesh.make_mesh_for(cfg, multi_pod=mp)
        fab = jmesh.fabric_for(cfg, multi_pod=mp)
        prod = jmesh.make_production_fabric(multi_pod=mp)
        moe = jmesh.make_moe_fabric(multi_pod=mp)
        info = jmesh.mesh_info_for(cfg, mesh)
        r = ra["multi" if mp else "single"] = {
            "shape": list(mesh.devices.shape), "names": list(fab.axis_names),
            "production": [list(prod.mesh.devices.shape),
                           list(prod.axis_names)],
            "moe": [list(moe.mesh.devices.shape), list(moe.axis_names)],
            "model_axes": list(jmesh.model_axes(mesh)),
            "batch_axes": list(jmesh.batch_axes(mesh)),
            "info": None if info is None else {
                k: getattr(info, k) for k in (
                    "data_axis", "expert_axis", "tp_axis", "pod_axis",
                    "hierarchical", "fsdp", "fuse_tp")}}
        for fsdp in (True, False):
            r["params_%s" % fsdp] = flat(jsh.param_shardings(
                cfg, mesh, pshape, fsdp=fsdp), lambda s: spec(s.spec))
        r["param_shapes"] = flat(pshape, lambda s: list(s.shape))
        r["rules"] = {"none": {k: plain(v) for k, v in
                               jsh.logical_rules(cfg, mesh, None).items()}}
        r["batch"], r["cache"] = {}, {}
        for s in cfg.shape_cells():
            r["rules"][s.name] = {k: plain(v) for k, v in
                                  jsh.logical_rules(cfg, mesh, s).items()}
            if s.kind in ("train", "prefill"):
                r["batch"][s.name] = {
                    k: [list(v.shape), str(v.dtype), spec(v.sharding.spec)]
                    for k, v in jsh.batch_struct(cfg, s, mesh).items()}
            else:
                cs = jax.eval_shape(lambda: model.init_cache(
                    s.global_batch, s.seq_len, jnp.bfloat16))
                shp = flat(cs, lambda x: list(x.shape))
                sp = flat(jsh.cache_shardings(cfg, s, mesh, cs),
                          lambda x: spec(x.spec))
                r["cache"][s.name] = {k: [shp[k], sp[k]] for k in shp}
print("RESULT " + json.dumps(res))
"""


@pytest.fixture(scope="module")
def ref():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", REF], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("RESULT ")]
    return json.loads(line[0][len("RESULT "):])


def _spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in p]


def _plain(v):
    return list(v) if isinstance(v, tuple) else v


def _strip(path):
    """A port path without its layer index (``blocks/3/attn/wq`` ->
    ``blocks/attn/wq``), the reference's stacked path."""
    return "/".join(p for p in path.split("/") if not p.isdigit())


def _meta_model(cfg):
    return build_model(cfg, dtype=torch.bfloat16,
                       device="meta").init(common.MetaGenerator())


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fabrics_and_axes_equal_the_reference(ref, arch, multi):
    cfg = get_config(arch)
    r = ref["archs"][arch]["multi" if multi else "single"]
    fab = mesh.make_mesh_for(cfg, multi_pod=multi)
    assert fab is not None and isinstance(fab, mesh.Fabric)
    assert [list(fab.shape), list(fab.axis_names)] == [r["shape"], r["names"]]
    for factory, key in ((mesh.make_production_mesh, "production"),
                         (mesh.make_moe_mesh, "moe")):
        f = factory(multi_pod=multi)
        assert [list(f.shape), list(f.axis_names)] == r[key]
        assert f.device == torch.device("meta")
    assert list(mesh.model_axes(fab)) == r["model_axes"]
    assert list(mesh.batch_axes(fab)) == r["batch_axes"]
    info = mesh.mesh_info_for(cfg, fab)
    if r["info"] is None:
        assert info is None
    else:
        assert info.mesh is fab
        assert {k: getattr(info, k) for k in r["info"]} == r["info"]


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_spec_tables_equal_the_reference(ref, arch, multi):
    """Parameters (``fsdp`` True and False), batches, caches and logical
    rules; a stacked leaf's spec is the reference's without its leading
    (layer) entry, which the reference never shards."""
    cfg = get_config(arch)
    r = ref["archs"][arch]["multi" if multi else "single"]
    fab = mesh.fabric_for(cfg, multi_pod=multi)
    model = _meta_model(cfg)
    params = model.paths()
    assert {_strip(k) for k in params} == set(r["param_shapes"])
    n = 0
    for fsdp in (True, False):
        got = sharding.param_shardings(cfg, fab, params, fsdp=fsdp)
        for k, v in got.items():
            want, shp = r[f"params_{fsdp}"][_strip(k)], r["param_shapes"][
                _strip(k)]
            if _strip(k) != k:
                assert want[0] is None and shp[1:] == list(params[k].shape)
                want = want[1:]
            else:
                assert shp == list(params[k].shape)
            assert _spec(v) == want, (k, fsdp)
            n += 1
    assert n == 2 * len(params)
    rules = {"none": sharding.logical_rules(cfg, fab, None)}
    for s in cfg.shape_cells():
        rules[s.name] = sharding.logical_rules(cfg, fab, s)
        if s.kind in ("train", "prefill"):
            got = {k: [list(v.shape), str(v.dtype).replace("torch.", ""),
                       _spec(v.spec)]
                   for k, v in sharding.batch_struct(cfg, s, fab).items()}
            assert got == r["batch"][s.name], s.name
            continue
        cache = model.init_cache(s.global_batch, s.seq_len, torch.bfloat16)
        specs = sharding.cache_shardings(cfg, s, fab, cache)
        seen = {}

        def walk(t, sp, path):
            if isinstance(t, dict):
                for k in t:
                    walk(t[k], sp[k], path + [k])
            elif isinstance(t, tuple) and hasattr(t, "_fields"):
                for f in t._fields:
                    walk(getattr(t, f), getattr(sp, f), path + [f])
            elif isinstance(t, list):
                for i, (a, b) in enumerate(zip(t, sp)):
                    walk(a, b, path + [str(i)])
            else:
                shp = list(t.shape) if isinstance(t, torch.Tensor) else []
                seen.setdefault(_strip("/".join(path)), set()).add(
                    json.dumps([shp, _spec(sp)]))
        walk(cache, specs, [])
        want = {k: {json.dumps([shp[1:], sp[1:]])}
                for k, (shp, sp) in r["cache"][s.name].items()}
        assert seen == want, s.name
    assert {k: {a: _plain(b) for a, b in v.items()}
            for k, v in rules.items()} == r["rules"]


def test_hillclimb_variants_equal_the_reference(ref):
    got = [[c, list(cell), tag, {k: repr(v) for k, v in kw.items()}, h]
           for c, cell, tag, kw, h in hillclimb.VARIANTS]
    assert got == ref["variants"]


def test_reference_dryrun_and_hillclimb_set_xla_flags_when_imported():
    """Why the reference's two modules are read in a subprocess: both set
    ``XLA_FLAGS`` at import, before any docstring."""
    for name in ("dryrun", "hillclimb"):
        tree = ast.parse(open(os.path.join(SRC, "repro", "launch",
                                           f"{name}.py")).read())
        first = tree.body[1]
        assert isinstance(first, ast.Assign)
        assert "XLA_FLAGS" in ast.unparse(first)


# ---------------------------------------------------------------------------
# the meta device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_size_arch_builds_on_meta_drawing_nothing(arch, monkeypatch):
    """Every leaf of the full-size model, its AdamW moments and its
    decode cache on meta; no generator draw (``torch.randn`` raises if
    called); the host allocates under 16 MiB for it."""
    def no_draw(*a, **k):
        raise AssertionError("a draw while building on meta")
    monkeypatch.setattr(torch, "randn", no_draw)
    cfg = get_config(arch)
    tracemalloc.start()
    try:
        model = _meta_model(cfg)
        params = model.paths()
        state = steps.default_optimizer().init(params)
        cache = model.init_cache(128, 32768, torch.bfloat16)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    leaves = list(params.values()) + list(state.mu.values()) + [
        t for t, _ in dryrun._pairs(cache, cache)]
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(p.numel() for p in params.values()) > 1e9
    assert peak < 16 << 20


def test_meta_init_changes_no_value():
    """On a real generator the initialisers draw exactly what
    ``torch.randn`` draws."""
    gen = torch.Generator()
    gen.manual_seed(7)
    got = common.dense_init(gen, 16, (3, 4), scale=0.5)
    gen.manual_seed(7)
    want = torch.randn((16, 3, 4), generator=gen) * (0.5 / 4.0)
    assert torch.equal(got, want)
    meta = common.dense_init(common.MetaGenerator(), 16, (3, 4))
    assert meta.device.type == "meta" and meta.shape == (16, 3, 4)


def test_production_fabrics_hold_no_memory():
    """A 512-shard fabric is its names and sizes: building it and its
    MeshInfo allocates under 64 KiB on the host and nothing on a card."""
    tracemalloc.start()
    try:
        for multi in (False, True):
            for cfg in (get_config("granite-8b"), get_config("olmoe-1b-7b")):
                fab = mesh.fabric_for(cfg, multi_pod=multi, device="cpu")
                mesh.mesh_info_for(cfg, fab)
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert peak < 64 << 10
    assert not any(isinstance(v, torch.Tensor) for v in vars(fab).values())


def test_every_cell_lays_out_on_meta():
    """The whole table, single and multi: records for every applicable
    cell, the skips where ``shape_cells`` says, no error; argument bytes
    a shard below the cell's whole inputs."""
    results = dryrun.run_sweep(
        dryrun.tasks_for(list(ARCH_IDS), list(dryrun.SHAPE_NAMES),
                         [False, True], verbose=False),
        out=None, resume=False)
    assert not [r for r in results if "error" in r]
    skipped = {(r["arch"], r["shape"]) for r in results if "skipped" in r}
    assert skipped == {(a, "long_500k") for a in ARCH_IDS
                       if not get_config(a).sub_quadratic}
    for r in results:
        if "skipped" in r:
            continue
        assert set(dryrun.RECORD_KEYS) <= set(r)
        assert r["collective_s"] is None and r["temp_size_in_bytes"] is None
        assert r["bottleneck"] in ("compute", "memory")
        assert 0 < r["argument_size_in_bytes"]
    single = {(r["arch"], r["shape"]): r["argument_size_in_bytes"]
              for r in results if r.get("mesh") == "single" and "chips" in r}
    multi = {(r["arch"], r["shape"]): r["argument_size_in_bytes"]
             for r in results if r.get("mesh") == "multi" and "chips" in r}
    assert all(multi[k] <= single[k] for k in single)


def test_dryrun_measure_on_the_cpu_writes_every_key(tmp_path):
    out = tmp_path / "dry.json"
    dryrun.main(["--arch", "olmoe-1b-7b", "--shape", "train_4k", "--mesh",
                 "single", "--reduced", "--measure", "--device", "cpu",
                 "--measure-batch", "2", "--measure-seq", "64", "--out",
                 str(out)])
    (rec,) = json.loads(out.read_text())
    assert set(dryrun.RECORD_KEYS) <= set(rec)
    m = rec["measured"]
    assert set(dryrun.MEASURED_KEYS) == set(m)
    assert m["device"] == "cpu" and m["timer"] == "host clock"
    assert m["peak_bytes"] is None and m["compute_share"] is None
    assert m["step_ms"] > 0 and (m["batch"], m["seq"]) == (2, 64)
    assert m["reduced"] == ["batch 256 -> 2", "sequence 4096 -> 64",
                            "fabric 16x8x2 -> 2x4x1"]
    assert m["fabric"] == "2x4x1 data,expert,tp"
    assert "— |" in report.measured_table([rec])


def test_dryrun_default_output_is_not_the_references():
    assert os.path.basename(dryrun.DEFAULT_OUT) == "dryrun_results_torch.json"
    ignored = open(os.path.join(SRC, "..", ".gitignore")).read().split()
    assert "dryrun_results_torch.json" in ignored


def test_measured_cuts_come_from_the_table_or_the_caller():
    """``measure`` with no cut named takes the cell's ``MEASURE_AT``
    entry; a cell without one, or a reduced config, raises before
    anything is built."""
    for (arch, shape), at in dryrun.MEASURE_AT.items():
        cfg = get_config(arch)
        assert shape in {s.name for s in cfg.shape_cells()}
        assert set(at) == {"layers", "batch", "seq"}
        assert at["layers"] <= cfg.num_layers
        assert at["batch"] <= SHAPES[shape].global_batch
        assert at["seq"] <= SHAPES[shape].seq_len
    for arch, shape, reduced in (("rwkv6-7b", "long_500k", False),
                                 ("mixtral-8x22b", "train_4k", False),
                                 ("granite-8b", "train_4k", True)):
        with pytest.raises(ValueError, match="no measured cut"):
            dryrun.lower_cell(arch, shape, False, reduced=reduced,
                              measure=True, device="cpu", verbose=False)


def test_train_step_checks_its_shape_against_the_rules():
    cfg = get_config("granite-8b").reduced()
    model = build_model(cfg, device="meta").init(common.MetaGenerator())
    opt = steps.default_optimizer()
    fab = mesh.make_production_fabric()
    assert steps.check_shape(model, SHAPES["train_4k"], fab) == \
        sharding.logical_rules(cfg, fab, SHAPES["train_4k"])
    steps.make_train_step(model, opt, shape=SHAPES["train_4k"])
    with pytest.raises(ValueError, match="sequence 4100"):
        steps.check_shape(model, ShapeConfig("t", 4100, 256, "train"), fab)
    with pytest.raises(ValueError, match="batch 40"):
        steps.check_shape(model, ShapeConfig("t", 4096, 40, "train"), fab)
    with pytest.raises(ValueError, match="micro-batches"):
        steps.make_train_step(model, opt, shape=ShapeConfig(
            "t", 64, 3, "train"), accum_steps=2)
    with pytest.raises(ValueError, match="'decode'"):
        steps.make_train_step(model, opt, shape=SHAPES["decode_32k"])
