"""One ``moe_dcra`` case of ``tests/test_torch_moe.py::CASES`` on a port
fabric, its output, statistics and gradients as numpy arrays.

Shared by ``tests/test_torch_moe_distributed.py`` and the gloo workers
it starts, which import nothing of JAX: the case's weights, tokens and
cotangent come from an ``.npz`` the test writes.
"""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.dispatch import MeshInfo, moe_dcra

WEIGHTS = ("router", "wg", "wu", "wd")


def run_case(name, spec, fabric, data):
    """``spec`` is ``CASES[name]`` (fabric, MeshInfo kwargs, experts,
    capacity factor, x shape, skew); ``data`` maps ``name/param/<k>``,
    ``name/x`` and ``name/cot`` to arrays. Returns ``name/<key>`` ->
    array: ``out``, ``aux``, ``topk``, each bucket stage's admitted and
    dropped counts, the gradients of ``sum(out * cot)`` with respect to
    the four weights and x (``grad_out/<k>``) and of ``aux`` with
    respect to the router and x (``grad_aux/<k>``)."""
    _, kw, experts, factor, _, _ = spec
    base = get_config("olmoe-1b-7b").reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, num_experts=experts, capacity_factor=factor))
    params = {k: torch.from_numpy(np.array(data[f"{name}/param/{k}"])
                                  ).requires_grad_(True) for k in WEIGHTS}
    x = torch.from_numpy(np.array(data[f"{name}/x"])).requires_grad_(True)
    cot = torch.from_numpy(np.array(data[f"{name}/cot"]))
    out, aux, stats = moe_dcra(params, x, cfg, MeshInfo(fabric, **kw),
                               return_stats=True)
    leaves = [params[k] for k in WEIGHTS] + [x]
    g_out = torch.autograd.grad((out * cot).sum(), leaves, retain_graph=True)
    g_aux = torch.autograd.grad(aux, [params["router"], x])
    res = {"out": out, "aux": aux, "topk": stats.topk_ids}
    for stage, (admitted, dropped) in stats.buckets.items():
        res[f"{stage}/admitted"], res[f"{stage}/dropped"] = admitted, dropped
    res.update({f"grad_out/{k}": g for k, g in zip(WEIGHTS + ("x",), g_out)})
    res.update({f"grad_aux/{k}": g for k, g in zip(("router", "x"), g_aux)})
    return {f"{name}/{k}": v.detach().numpy() for k, v in res.items()}
