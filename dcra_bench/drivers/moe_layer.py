"""A stack of MoE layers through the port's owner-routed dispatch
(``repro_torch.core.dispatch.moe_dcra``) on a virtual-shard packaging:
each forward step takes fresh tokens from the seed through every layer,
adding each layer's output to its input (the residual stream of the
model's MoE blocks, with no attention between them), one step in flight
(each step's output waited for before the next step's tokens are made).

End-to-end: ``tokens_per_s`` (the tokens of every step of the window,
over the window) and ``setup_s`` (process start to window start:
imports, the weights made on the card, the warm steps, and on a
checkout's first run the kernels' build). Every layer of every step of
the window asks the port for its dispatch statistics, so every drop is
counted; each layer's output in the sampled steps is compared with the
plain float32 layer on that layer's input.
"""
from __future__ import annotations

import time

from dcra_bench.gen import moe_inputs, seeds
from dcra_bench.harness import Check, Run, worse
from dcra_bench.reference import moe as reference
from dcra_bench.trace import Window

TAG_SAMPLE = 302
WARM_STEP = 1 << 40        # the warm steps' tokens are not the window's
#: ``||out - reference|| / ||reference||`` over a step's tokens (bfloat16
#: rounding of the FFN and the output): sound runs read about 0.0043, the
#: float8 control 0.0655 (PERF.md gives the readings)
REL_RMS_LIMIT = 0.02
#: the widest ``||out_t - reference_t|| / ||reference_t||`` of one token:
#: sound runs read at most about 0.006, the float8 control 0.076
TOKEN_REL_LIMIT = 0.03
#: a token whose k-th and (k+1)-th router logits (float64) lie closer than
#: this may be routed either way by a float32 router: left out, counted
TIE_MARGIN = 1e-3


def arch_config(cfg):
    from repro_torch.configs.base import ArchConfig, MoEConfig
    return ArchConfig(
        name=cfg["name"], family="moe",
        num_layers=int(cfg["num_hidden_layers"]),
        d_model=int(cfg["hidden_size"]), num_heads=0, num_kv_heads=0,
        d_ff=int(cfg["intermediate_size"]), vocab_size=1,
        moe=MoEConfig(num_experts=int(cfg["num_experts"]),
                      top_k=int(cfg["num_experts_per_tok"]),
                      d_expert=int(cfg["intermediate_size"]),
                      dispatch_impl="dcra"))


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(ctx) -> Run:
    import torch
    from repro_torch.core.dispatch import MeshInfo, moe_dcra
    from repro_torch.core.fabric import Fabric
    from repro_torch.core.queues import QueueConfig
    cfg, tr, dev, spans = ctx.config, ctx.traffic, ctx.device, ctx.spans
    arch = arch_config(cfg)
    pk = cfg["packaging"]
    info = MeshInfo(Fabric.virtual(pk["shape"], pk["axes"], device=dev))
    queues = QueueConfig(default_iq=None,
                         iq_factors=dict(cfg["queue_factors"]))
    with spans("generate"):
        params = moe_inputs.weights(cfg, ctx.seed, dev)
        layers = [moe_inputs.layer(params, i)
                  for i in range(int(cfg["num_hidden_layers"]))]
        means = moe_inputs.topic_means(cfg, tr, params["router"], ctx.seed,
                                       dev)
        _sync(dev)

    def step(i, keep):
        with spans("inputs"):
            x = moe_inputs.tokens(cfg, tr, ctx.seed, i, dev, means)
        outs, dropped = [], 0
        with spans("layers"):
            for p in layers:
                out, _, stats = moe_dcra(p, x, arch, info, queues=queues,
                                         return_stats=True)
                dropped = dropped + sum(d.sum()
                                        for _, d in stats.buckets.values())
                x = x + out
                if keep:
                    outs.append(out)
            del stats
        with spans("sync"):
            _sync(dev)
        return outs, dropped

    with spans("warm"):
        for j in range(int(tr["warm_steps"])):
            step(WARM_STEP + j, False)

    keep = set(seeds.sample(tr["sample_range"], tr["checked_steps"],
                            ctx.seed, TAG_SAMPLE))
    kept, drops = {}, []
    with Window(ctx) as win:
        i = 0
        while True:
            outs, dropped = step(i, i in keep)
            drops.append(dropped)
            if i in keep:
                kept[i] = outs
            i += 1
            if (i > max(keep)
                    and time.perf_counter() - win.t_start >= ctx.seconds):
                win.close()
                break
    setup_s = win.t_start - ctx.t0
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    del outs, info, layers
    n_steps = i
    drop_counts = torch.stack([torch.as_tensor(d) for d in drops]).cpu()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    with spans("check"):
        checks, failed = check(cfg, tr, ctx.seed, params, means, kept,
                               drop_counts, dev)
    tokens = int(tr["batch"]) * int(tr["seq_len"])
    return Run(
        e2e={"tokens_per_s": n_steps * tokens / win.seconds,
             "setup_s": setup_s},
        checks=checks, attempted=n_steps, failed=len(failed),
        memory_peak_bytes=peak, spans=spans, trace=win.summary,
        counters={"steps": n_steps},
        work={"steps": n_steps, "tokens": tokens,
              "layers": int(cfg["num_hidden_layers"]),
              "window_s": win.seconds})


def check(cfg, tr, seed, params, means, kept, drop_counts, device,
          fp8=False):
    """Each kept step's layer outputs against the plain layer on the same
    layer input and weights, the input of layer ``l + 1`` being that of
    ``l`` plus the port's output, as the step adds them (``kept[j]`` None:
    the plain layer with its experts in float8 in the port's place, the
    control), and every step's drops. -> ``(checks, failed step
    indices)``."""
    import sys
    k = int(cfg["num_experts_per_tok"])
    worst, worst_token, failed, near_total = 0.0, 0.0, set(), 0
    for j in sorted(kept):
        x = moe_inputs.tokens(cfg, tr, seed, j, device, means)
        for i in range(int(cfg["num_hidden_layers"])):
            p = moe_inputs.layer(params, i)
            args = (x, p["router"], p["wg"], p["wu"], p["wd"], k, TIE_MARGIN)
            want, near = reference.moe_layer(*args)
            if kept[j] is None:
                out = reference.moe_layer(*args, fp8=True)[0].to(
                    x.dtype).reshape(x.shape)
            else:
                out = kept[j][i]
            err = reference.rel_rms(out.float(), want, ~near)
            tok = reference.token_rel_max(out.float(), want, ~near)
            near_total += int(near.sum())
            if not (err <= REL_RMS_LIMIT and tok <= TOKEN_REL_LIMIT):
                failed.add(j)
            worst = worse(worst, err)
            worst_token = worse(worst_token, tok)
            x = x + out
    failed |= {int(j) for j in torch_nonzero(drop_counts)}
    print(f"moe check: {len(kept)} steps of {cfg['num_hidden_layers']} "
          f"layers compared, {near_total} token-layers at a near tie "
          f"(router logits within {TIE_MARGIN}) left out", file=sys.stderr)
    return ([Check("moe_out_rel_rms", worst, REL_RMS_LIMIT),
             Check("moe_token_rel_max", worst_token, TOKEN_REL_LIMIT),
             Check("moe_drops", int(drop_counts.sum()), 0)], failed)


def torch_nonzero(t):
    return t.nonzero().reshape(-1).tolist()
