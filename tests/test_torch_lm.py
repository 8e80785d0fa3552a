"""The port's decoder-LM serving and training paths on their own (no
reference needed): weights from a generator and shared across activation
types, the device and family rules, and the ``launch/serve.py`` CLI on
the CPU; on the card, the flash kernel as the attention layers' kernel,
its refusal of a gradient, and a train step through ``moe_dcra`` against
the same step on the CPU. This file imports torch, numpy and the port
only (no jax), so that it runs on a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm.py

The ``cuda`` tests skip without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, TRAIN_4K, ShapeConfig, get_config
from repro_torch.core.dispatch import MeshInfo
from repro_torch.core.fabric import Fabric
from repro_torch.data.pipeline import synth_batch
from repro_torch.kernels import flash_attention as tflash
from repro_torch.kernels import route as troute
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.launch.train import reduced_batch
from repro_torch.models.attention import flash_attend
from repro_torch.models.model_zoo import build_model
from repro_torch.models.transformer import padded_vocab


def _batch(cfg, B=2, S=64):
    return synth_batch(cfg, ShapeConfig("t", S, B, "train"), 0)


def _model(arch, device, dtype=torch.float32, **replace):
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    return build_model(cfg, dtype=dtype, device=device).init(gen)


def test_init_draws_on_the_generator_and_shares_weights_across_dtypes():
    cfg = get_config("internlm2-1.8b").reduced()
    gen = torch.Generator()
    gen.manual_seed(1)
    m = build_model(cfg, device="cpu").init(gen)
    gen.manual_seed(1)
    m2 = build_model(cfg, device="cpu").init(gen)
    for (n, a), (_, b) in zip(m.named_parameters(), m2.named_parameters()):
        assert torch.equal(a, b), n
    assert m.embed.shape == (256, cfg.d_model)
    bf = build_model(cfg, dtype=torch.bfloat16, device="cpu")
    bf.load(m.tree())
    assert bf.blocks[0].attn.wq.data_ptr() == m.blocks[0].attn.wq.data_ptr()
    logits, _ = bf.forward({"tokens": np.zeros((1, 8), np.int32)})
    assert logits.dtype == torch.bfloat16


def test_unported_families_and_devices_raise():
    """The six families build on the device given; a family the reference
    does not know raises, naming the known ones."""
    cfg = get_config("granite-8b").reduced()
    with pytest.raises(KeyError, match="unknown family 'retnet'"):
        build_model(dataclasses.replace(cfg, family="retnet"), device="cpu")
    for arch in ("rwkv6-7b", "zamba2-7b", "seamless-m4t-large-v2"):
        m = build_model(get_config(arch).reduced(), device="cpu")
        assert m.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    with pytest.raises(ValueError, match="generator"):
        build_model(cfg, device="meta").init(torch.Generator())
    if torch.cuda.is_available():      # a card named with or without index
        build_model(cfg, device="cuda:0").init(torch.Generator("cuda"))


# ---------------------------------------------------------------------------
# every arch (the counterpart of tests/test_configs_smoke.py)
# ---------------------------------------------------------------------------

#: train_4k cut to batch 2, seq 64, as the reference's smoke test cuts it
SMOKE_SHAPE = dataclasses.replace(TRAIN_4K, global_batch=2, seq_len=64)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_train_step(arch):
    """Reduced same-family config, weights from a generator, the full
    config's ``synth_batch`` (tokens clipped to the reduced vocab, frames
    and patches cut or repeated to its width): one forward (logits [2,
    S, padded vocab], finite) and one train step (finite loss, the
    parameters moved)."""
    full = get_config(arch)
    cfg = full.reduced()
    model = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    batch = reduced_batch(full, cfg, SMOKE_SHAPE, 0, "cpu")
    logits, aux = model.forward(batch)
    assert logits.shape == (2, batch["tokens"].shape[1],
                            padded_vocab(cfg.vocab_size))
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))
    opt = tsteps.default_optimizer()
    step = tsteps.make_train_step(model, opt)
    first = next(iter(model.paths()))
    p0 = model.paths()[first].detach().clone()
    params, _, metrics = step(model.paths(), opt.init(model.paths()), batch)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.allclose(params[first].detach(), p0)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_dims_match_assignment(arch):
    """The full configs carry the published dimensions (the reference's
    table, ``tests/test_configs_smoke.py``)."""
    cfg = get_config(arch)
    expect = {
        "mixtral-8x22b": (56, 6144, 48, 8, 16384, 32768),
        "olmoe-1b-7b": (16, 2048, 16, 16, 1024, 50304),
        "granite-8b": (36, 4096, 32, 8, 14336, 49152),
        "h2o-danube-3-4b": (24, 3840, 32, 8, 10240, 32000),
        "internlm2-1.8b": (24, 2048, 16, 8, 8192, 92544),
        "qwen2-1.5b": (28, 1536, 12, 2, 8960, 151936),
        "seamless-m4t-large-v2": (24, 1024, 16, 16, 8192, 256206),
        "qwen2-vl-7b": (28, 3584, 28, 4, 18944, 152064),
        "rwkv6-7b": (32, 4096, 0, 0, 14336, 65536),
        "zamba2-7b": (81, 3584, 32, 32, 14336, 32000),
    }[arch]
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == expect
    extra = {
        "mixtral-8x22b": lambda c: (c.moe.num_experts == 8
                                    and c.moe.top_k == 2
                                    and c.sliding_window > 0),
        "olmoe-1b-7b": lambda c: c.moe.num_experts == 64 and c.moe.top_k == 8,
        "zamba2-7b": lambda c: (c.ssm.state_dim == 64
                                and c.resolved_head_dim == 112
                                and c.hybrid_attn_period == 6),
        "seamless-m4t-large-v2": lambda c: c.encoder_layers == 24,
        "rwkv6-7b": lambda c: c.ssm.head_dim == 64 and c.attn_free,
        "qwen2-vl-7b": lambda c: c.mrope and c.qkv_bias,
        "qwen2-1.5b": lambda c: c.qkv_bias,
    }.get(arch, lambda c: True)
    assert extra(cfg)


@pytest.mark.parametrize("arch", ["rwkv6-7b", "zamba2-7b",
                                  "seamless-m4t-large-v2"])
def test_serve_and_train_clis_run_the_recurrent_families(arch, capsys):
    """``launch/serve.py`` and ``launch/train.py`` on the reduced
    recurrent, hybrid and encoder-decoder configs, on the CPU."""
    from repro_torch.launch import train
    tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert "generated (2, 3) on cpu" in capsys.readouterr().out
    res = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--steps", "2", "--batch", "2", "--seq", "64"])
    assert res.final_step == 2 and all(
        np.isfinite(m["loss"]) for m in res.metrics_history)


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", "qwen2-vl-7b", "--reduced", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) on cpu" in out


def test_serve_and_prefill_steps_follow_serve():
    """``make_serve_step`` fed the prompt then its own ids gives
    ``serve``'s greedy ids; ``make_prefill_step`` gives the first of them
    from one forward; ``make_train_step`` refuses another ``MeshInfo``
    than the model's."""
    m = _model("qwen2-1.5b", "cpu")
    prompts = torch.from_numpy(np.random.default_rng(5).integers(
        0, m.cfg.vocab_size, (2, 6)).astype(np.int32))
    want = tserve.serve(m.cfg, m, prompts, 4)
    step = tsteps.make_serve_step(m)
    cache = m.init_cache(2, 10, torch.float32)
    got = []
    for t in range(9):
        tok = prompts[:, t:t + 1] if t < 6 else got[-1]
        nxt, cache = step(cache, tok, t)
        assert nxt.dtype == torch.int32 and nxt.shape == (2, 1)
        if t >= 5:
            got.append(nxt)
    assert torch.equal(torch.cat(got, 1), want)
    first = tsteps.make_prefill_step(m)({"tokens": prompts})
    assert torch.equal(first, want[:, 0])
    with pytest.raises(ValueError, match="mesh_info"):
        tsteps.make_train_step(m, tsteps.default_optimizer(), mesh_info=(
            MeshInfo(Fabric.virtual((2, 2, 1), ("data", "expert", "tp"),
                                    device="cpu"))))


def test_restart_replays_the_uninterrupted_losses(tmp_path):
    """``launch/train.py``'s trainer under ``run_training``: a failure at
    step 7 with a checkpoint every 5 steps restores step 4's parameters
    and AdamW state and replays steps 5 and 6: the 10 losses of the run
    without the failure, within 1e-6 relative (the same ops on the same
    values, but two uninterrupted runs on the CPU may already differ in
    the last bits: its sums are not repeatable bit for bit)."""
    from repro_torch.launch import train
    from repro_torch.runtime.fault_tolerance import FailurePlan, run_training
    args = train.parser().parse_args(["--reduced", "--steps", "10", "--batch",
                                      "2", "--seq", "32", "--device", "cpu"])
    runs = []
    for plan in (None, FailurePlan({7: "injected"})):
        step_fn, init_state, batch_fn = train.trainer(args)
        res = run_training(step_fn, init_state, batch_fn, 10,
                           str(tmp_path / str(len(runs))), ckpt_every=5,
                           failure_plan=plan)
        runs.append(res)
    assert [r.restarts for r in runs] == [0, 1]
    assert [r.final_step for r in runs] == [10, 10]
    assert np.allclose([m["loss"] for m in runs[1].metrics_history],
                       [m["loss"] for m in runs[0].metrics_history],
                       rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,design", [(torch.float32, "blocked"),
                                          (torch.bfloat16, "wgmma")])
def test_cuda_forward_runs_the_kernel_and_matches_the_torch_path(
        cuda_device, dtype, design):
    """Reduced granite-8b at hd 128 on the card: one kernel launch a
    layer on the design its type picks, the logits within 1e-4 (float32)
    or ``2^-7 (1 + 2 sqrt(L))`` (bf16: logits one bf16 ulp apart, the
    stream's roundings a random walk over the layers; ``chip_smoke.py``'s
    ``logit_bound``) of max|logit| of the torch path's; decode (``serve``)
    launches none."""
    m = _model("granite-8b", cuda_device, dtype, head_dim=128)
    L = m.cfg.num_layers
    batch = _batch(m.cfg, S=300)
    with torch.inference_mode():
        tflash.reset_launches()
        got, _ = m.forward(batch)
        assert tflash.PATHS[design] == L
        assert tflash.LAUNCHES["flash_attention"] == L
        want, _ = m.forward(batch, kernel=False)
    tserve.serve(m.cfg, m, torch.as_tensor(batch["tokens"][:, :4]), 2)
    assert tflash.LAUNCHES["flash_attention"] == L
    scale = float(want.float().abs().max())
    bound = (1e-4 if dtype == torch.float32
             else 2.0 ** -7 * (1 + 2 * L ** 0.5)) * scale
    assert float((got.float() - want.float()).abs().max()) <= bound


@pytest.mark.cuda
@pytest.mark.parametrize("arch,seq,launches", [
    ("qwen2-vl-7b", 64, 0),         # positions from the batch
    ("h2o-danube-3-4b", 64, 0),     # SWA window 16 < S
    ("h2o-danube-3-4b", 16, 2),     # S <= window: the mask is causal
    ("olmoe-1b-7b", 64, 2)])
def test_cuda_attention_takes_the_kernel_where_its_mask_is_the_layers(
        cuda_device, arch, seq, launches):
    m = _model(arch, cuda_device)
    with torch.inference_mode():
        tflash.reset_launches()
        logits, _ = m.forward(_batch(m.cfg, S=seq))
    assert tflash.LAUNCHES["flash_attention"] == launches
    assert bool(torch.isfinite(logits).all())


def _bf16_bound(L):
    """bf16 logits of two runs that round at other points, as a share of
    max|logit| (``chip_smoke.py``'s ``logit_bound``): ``2^-7 (1 + 2
    sqrt(L))`` over the L layers the stream passes."""
    return 2.0 ** -7 * (1 + 2 * L ** 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,design", [(torch.float32, "blocked"),
                                          (torch.bfloat16, "wgmma")])
def test_cuda_zamba2_shared_block_runs_the_kernel_at_hd_112(
        cuda_device, dtype, design):
    """Reduced zamba2-7b at its head width 112 (a 224-byte TMA row,
    padded to 128 on wgmma), 5 Mamba2 layers at period 2: the shared
    block on the flash kernel, one causal launch an application (2) on
    the design its type picks. float32: the logits within 1e-4 of
    max|logit| of the torch path's. bf16: a Mamba2 stack with random
    weights amplifies a rounding (its bf16 logits lie a tenth or more of
    max|logit| from its float32 ones), so the kernel path's bf16 logits
    are held to lie within the bf16 bound farther from the float32
    forward's than the torch path's bf16 logits (``chip_smoke.py``'s
    hold for them)."""
    m = _model("zamba2-7b", cuda_device, dtype, head_dim=112, num_layers=5)
    batch = _batch(m.cfg, S=256)
    with torch.inference_mode():
        tflash.reset_launches()
        got, _ = m.forward(batch)
        assert tflash.PATHS[design] == tflash.LAUNCHES["flash_attention"] == 2
        want, _ = m.forward(batch, kernel=False)
        f32 = build_model(m.cfg, device=cuda_device)
        f32.load(m.tree())
        ref, _ = f32.forward(batch, kernel=False)
    assert tflash.LAUNCHES["flash_attention"] == 2
    scale = float(ref.abs().max())
    err_k, err_p = (float((t.float() - ref).abs().max()) / scale
                    for t in (got, want))
    if dtype == torch.float32:
        assert err_k <= 1e-4
    else:
        assert err_k <= err_p + _bf16_bound(5 + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,design", [(torch.float32, "blocked"),
                                          (torch.bfloat16, "wgmma")])
def test_cuda_seamless_encoder_runs_the_kernel_non_causal(
        cuda_device, dtype, design, monkeypatch):
    """Reduced seamless-m4t-large-v2 at its head width 64: the encoder's
    self-attention on the flash kernel without a mask (one launch a
    layer), then the decoder's causal, all on the design the type picks;
    the logits within 1e-4 (float32) or the bf16 bound of the torch
    path's."""
    from repro_torch.kernels import ops
    m = _model("seamless-m4t-large-v2", cuda_device, dtype, head_dim=64)
    masks = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention", lambda q, k, v, causal=True:
                        masks.append(causal) or real(q, k, v, causal))
    batch = _batch(m.cfg, S=512)
    with torch.inference_mode():
        tflash.reset_launches()
        got, _ = m.forward(batch)
        assert tflash.PATHS[design] == tflash.LAUNCHES["flash_attention"] == 4
        want, _ = m.forward(batch, kernel=False)
    assert masks == [False, False, True, True]
    scale = float(want.float().abs().max())
    bound = 1e-4 if dtype == torch.float32 else _bf16_bound(4)
    assert float((got.float() - want.float()).abs().max()) <= bound * scale


@pytest.mark.cuda
def test_cuda_flash_glue_refuses_a_gradient(cuda_device):
    """The flash kernel is forward-only: asked for a gradient on the card
    the glue raises, naming the training path's choice; without one it
    launches."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(1, 64, 4, 16, generator=g, device=cuda_device)
               for _ in range(3))
    with pytest.raises(NotImplementedError, match="kernel=False"):
        flash_attend(q.requires_grad_(True), k, v, True)
    m = _model("granite-8b", cuda_device)
    m.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="forward-only"):
        m.loss(_batch(m.cfg, S=32))
    with torch.no_grad():
        tflash.reset_launches()
        flash_attend(q, k, v, True)
    assert tflash.LAUNCHES["flash_attention"] == 1


@pytest.mark.cuda
def test_cuda_olmoe_train_step_through_moe_dcra_matches_the_cpu(
        cuda_device):
    """Reduced OLMoE-1B-7B with a ``MeshInfo`` over (data 2, expert 2,
    tp 1): one ``make_train_step`` step on the card through ``moe_dcra``
    (the ``bucket_scatter`` kernel, ``staged``: two buckets a layer a
    forward, twice with remat ``block``; no flash launch) against the
    same step on the CPU from the same weights and batch: the loss within
    1e-5 relative, every gradient leaf (the first moment) within 1e-4 of
    its max, the new parameters within 2 lr (AdamW's first update moves
    an entry by at most lr(1 + wd|p|))."""
    cfg = get_config("olmoe-1b-7b").reduced()
    shape, names = (2, 2, 1), ("data", "expert", "tp")
    gen = torch.Generator().manual_seed(3)
    cpu = build_model(cfg, mesh_info=MeshInfo(Fabric.virtual(
        shape, names, device="cpu"))).init(gen)
    card = build_model(cfg, mesh_info=MeshInfo(Fabric.virtual(
        shape, names, device=cuda_device)))
    card.load(_to(cpu.tree(), cuda_device))
    batch = _batch(cfg, S=64)
    out = {}
    for name, m in (("cpu", cpu), ("card", card)):
        opt = tsteps.default_optimizer()
        step = tsteps.make_train_step(m, opt)
        troute.reset_launches()
        tflash.reset_launches()
        params, state, metrics = step(m.paths(), opt.init(m.paths()), batch)
        out[name] = ({k: v.detach().cpu() for k, v in params.items()},
                     {k: v.cpu() for k, v in state.mu.items()},
                     float(metrics["loss"]))
    assert troute.LAUNCHES["bucket_scatter"] == 4 * cfg.num_layers
    assert troute.PATHS["bucket_scatter"]["staged"] == sum(
        troute.PATHS["bucket_scatter"].values()) == 4 * cfg.num_layers
    assert tflash.LAUNCHES["flash_attention"] == 0
    (p_cpu, mu_cpu, l_cpu), (p_card, mu_card, l_card) = out["cpu"], out["card"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    lr1 = float(tsteps.default_optimizer().lr(torch.tensor(1)))
    for k in p_cpu:
        scale = float(mu_cpu[k].abs().max())
        assert float((mu_card[k] - mu_cpu[k]).abs().max()) <= 1e-4 * scale, k
        assert float((p_card[k] - p_cpu[k]).abs().max()) <= 2 * lr1 * (
            1 + float(p_cpu[k].abs().max())), k


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,flash", [("train_4k", 0), ("prefill_32k", 2),
                                         ("decode_32k", 0)])
def test_cuda_dryrun_measures_a_cell_on_the_card(cuda_device, shape, flash):
    """``lower_cell(..., measure=True)`` on the card: CUDA events, the
    card's peak bytes and name, the flash kernel in every attention layer
    of the prefill (2 layers), none in training or decode."""
    from repro_torch.launch import dryrun
    rec = dryrun.lower_cell("granite-8b", shape, False, reduced=True,
                            measure=True, device=cuda_device, verbose=False,
                            measure_at={"layers": 2, "batch": 1, "seq": 256})
    m = rec["measured"]
    assert set(m) == set(dryrun.MEASURED_KEYS)
    assert m["timer"] == "cuda events" and m["step_ms"] > 0
    assert m["peak_bytes"] > 0 and m["device_name"] == \
        torch.cuda.get_device_name(cuda_device)
    assert m["compute_share"] > 0 and m["launches"]["flash_attention"] == flash
