"""The port's decoder-LM serving path on its own (no reference needed):
weights from a generator and shared across activation types, the device
and family rules, and the ``launch/serve.py`` CLI on the CPU; on the
card, the flash kernel as the attention layers' kernel. This file
imports torch, numpy and the port only (no jax), so that it runs on a
machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm.py

The ``cuda`` tests skip without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.data.pipeline import synth_batch
from repro_torch.kernels import flash_attention as tflash
from repro_torch.launch import serve as tserve
from repro_torch.models.model_zoo import build_model


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
    cfg = get_config("granite-8b").reduced()
    with pytest.raises(NotImplementedError, match="item 5b"):
        build_model(dataclasses.replace(cfg, family="ssm"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
    with pytest.raises(ValueError, match="generator"):
        build_model(cfg, device="meta").init(torch.Generator())
    if torch.cuda.is_available():      # a card named with or without index
        build_model(cfg, device="cuda:0").init(torch.Generator("cuda"))


def test_serve_cli_runs_on_the_cpu(capsys):
    tserve.main(["--arch", "qwen2-vl-7b", "--reduced", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "5", "--gen", "3"])
    out = capsys.readouterr().out
    assert "generated (2, 3) on cpu" in out


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
