"""Production fabrics: DCRA's "packaging-time" composition (counterpart of
``repro/launch/mesh.py:21-79``).

``make_production_fabric`` is the contract layout: a 256-chip pod (16 x
16, ``data, model``) or two pods (2 x 16 x 16, ``pod, data, model``).
``make_moe_fabric`` refines the 16-way ``model`` axis into ``expert x
tp`` (8 x 2) for the MoE architectures: the same chips, another
packaging.

The port has no device mesh: a layout is a virtual-shard
:class:`~repro_torch.core.fabric.Fabric`, so ``make_*_mesh`` and
``make_mesh_for`` return the fabric itself where the reference returns
``fabric.mesh``. A virtual fabric of 256 or 512 shards is its axis
names and sizes only: it holds no memory until a tensor is sharded onto
it. The fabrics default to the meta device, which the dry run builds on;
pass ``device`` to place one.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..configs.base import ArchConfig
from ..core.dispatch import MeshInfo
from ..core.fabric import Fabric

#: the device of a layout that only describes shapes (the dry run's)
META = torch.device("meta")


def make_production_fabric(*, multi_pod: bool = False,
                           device=META) -> Fabric:
    """The contract fabric: a 256-chip pod (16x16) or two pods
    (2x16x16, ``pod`` = the portal-crossing axis)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Fabric.virtual(shape, axes, device=device)


def make_production_mesh(*, multi_pod: bool = False, device=META) -> Fabric:
    """The reference's mesh of the contract layout: here its fabric."""
    return make_production_fabric(multi_pod=multi_pod, device=device)


def make_moe_fabric(*, multi_pod: bool = False, device=META) -> Fabric:
    """The model axis split into (expert, tp) for expert-parallel archs."""
    shape = (2, 16, 8, 2) if multi_pod else (16, 8, 2)
    axes = (("pod", "data", "expert", "tp") if multi_pod
            else ("data", "expert", "tp"))
    return Fabric.virtual(shape, axes, device=device)


def make_moe_mesh(*, multi_pod: bool = False, device=META) -> Fabric:
    return make_moe_fabric(multi_pod=multi_pod, device=device)


def fabric_for(cfg: ArchConfig, *, multi_pod: bool = False,
               device=META) -> Fabric:
    if cfg.moe is not None:
        return make_moe_fabric(multi_pod=multi_pod, device=device)
    return make_production_fabric(multi_pod=multi_pod, device=device)


def make_mesh_for(cfg: ArchConfig, *, multi_pod: bool = False,
                  device=META) -> Fabric:
    return fabric_for(cfg, multi_pod=multi_pod, device=device)


def mesh_info_for(cfg: ArchConfig, fabric: Fabric, hierarchical: bool = True
                  ) -> Optional[MeshInfo]:
    """The MoE layer's :class:`MeshInfo` over ``fabric`` (``None`` for a
    dense arch)."""
    if cfg.moe is None:
        return None
    return MeshInfo(
        mesh=fabric,
        data_axis="data",
        expert_axis="expert",
        tp_axis="tp",
        pod_axis="pod" if "pod" in fabric.axis_names else None,
        hierarchical=hierarchical,
    )


def model_axes(fabric: Fabric) -> tuple:
    """The tensor-parallel axis group ('model' or expert+tp)."""
    return ("model",) if "model" in fabric.axis_names else ("expert", "tp")


def batch_axes(fabric: Fabric) -> tuple:
    return ("pod", "data") if "pod" in fabric.axis_names else ("data",)
