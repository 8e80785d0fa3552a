"""A stack of MoE layers' weights and each step's tokens, made on the device
from a seed in the type they are served in.

Weights: one tensor a kind for all ``L`` layers, ``router [L, D, E]``,
``wg`` / ``wu [L, E, D, F]``, ``wd [L, E, F, D]``, normal with the
configuration's ``initializer_range`` as standard deviation.

Tokens ``x [B, S, D]``: standard normal (the scale of an RMS-normed hidden
state) plus the mean of the step's topic. A topic favours some experts:
in every layer the expert of rank ``r`` (an order drawn from the seed for
each topic and layer) gets the router logit offset ``s ln(1/r)``, a Zipf
law of exponent ``s`` over the experts, centred. The topic's mean is the
least-norm vector whose router logits in every layer are those offsets,
so the experts' loads are uneven as a batch of one domain makes them,
and every seed has the same load profile over other experts.
"""
from __future__ import annotations

from .seeds import generator, sub_seed

TAG_WEIGHTS = 201
TAG_TOPICS = 202
TAG_TOKENS = 1 << 20        # + step
TAG_TOPIC_OF_STEP = 1 << 41  # + step


def dtype_of(config):
    import torch
    return {"bfloat16": torch.bfloat16, "float16": torch.float16,
            "float32": torch.float32}[config["torch_dtype"]]


def weights(config, seed: int, device):
    import torch
    d, e = config["hidden_size"], config["num_experts"]
    f = config["intermediate_size"]
    n_layers = int(config["num_hidden_layers"])
    std = float(config["initializer_range"])
    dt = dtype_of(config)
    gen = generator(seed, TAG_WEIGHTS, device)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=device,
                           dtype=dt).mul_(std)
    return {"router": normal(n_layers, d, e),
            "wg": normal(n_layers, e, d, f), "wu": normal(n_layers, e, d, f),
            "wd": normal(n_layers, e, f, d)}


def layer(params, i: int):
    """Layer ``i``'s weights, in the layout ``moe_dcra`` takes."""
    return {k: v[i] for k, v in params.items()}


def topic_means(config, traffic, router, seed: int, device):
    """``[topics, D]`` float32: each topic's mean (module docstring). Needs
    ``L E <= D`` so that every layer's offsets are met exactly."""
    import torch
    n_layers, d, e = router.shape
    topics = int(traffic["topics"])
    gen = generator(seed, TAG_TOPICS, device)
    ranks = torch.argsort(torch.rand(topics, n_layers, e, generator=gen,
                                     device=device), dim=-1) + 1
    offsets = -float(traffic["zipf_s"]) * torch.log(ranks.float())
    offsets = offsets - offsets.mean(-1, keepdim=True)
    r = router.float().permute(1, 0, 2).reshape(d, n_layers * e)
    coef = torch.linalg.solve(r.T @ r, offsets.reshape(topics, -1).T)
    return (r @ coef).T.contiguous()


def topic_of(traffic, seed: int, step: int) -> int:
    return sub_seed(seed, TAG_TOPIC_OF_STEP + int(step)) % int(
        traffic["topics"])


def tokens(config, traffic, seed: int, step: int, device, means):
    """Step ``step``'s tokens: the same for the same seed and step."""
    import torch
    dt = dtype_of(config)
    gen = generator(seed, TAG_TOKENS + int(step), device)
    x = torch.randn(traffic["batch"], traffic["seq_len"],
                    config["hidden_size"], generator=gen, device=device,
                    dtype=dt)
    return x.add_(means[topic_of(traffic, seed, step)].to(dt))
