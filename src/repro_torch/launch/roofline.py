"""Roofline terms per (arch x shape x fabric) on the H100's own figures
(counterpart of ``repro/launch/roofline.py:24-113``).

Three terms, as the reference's:
  compute_s    = FLOPs / (chips x H100_PEAK_BF16_FLOPS)
  memory_s     = HBM bytes / (chips x H100_HBM_BW)
  collective_s = collective bytes / H100_NVLINK_BW

The reference reads the FLOPs and bytes of a compiled XLA module and
parses the collectives out of its HLO text. torch keeps no HLO, so
:func:`analyze` builds the terms from :mod:`repro_torch.launch.analytic`'s
closed forms (and, where one was timed, a measured step); the collective
term is ``None``. The HLO text parsers (:func:`_shape_bytes`,
:func:`collective_bytes`) are pure text functions, kept as they are.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, Optional

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
# (the card the port runs on: "NVIDIA H100 80GB HBM3, 700.00 W" by
# nvidia-smi); the figures PERF.md's kernel bounds use.
H100_PEAK_BF16_FLOPS = 989e12      # bf16 tensor cores, dense
H100_PEAK_F32_FLOPS = 67e12        # float32 outside the tensor cores
H100_HBM_BW = 3.35e12              # HBM3, bytes/s
H100_NVLINK_BW = 450e9             # NVLink 4, bytes/s a direction

#: why the collective term is empty on the port
NO_HLO = "no XLA HLO in torch"

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "tuple": 0, "token": 0, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLL_RE = re.compile(
    r"=\s*((?:\([^)]*\))|(?:[a-z0-9]+\[[^\]]*\][^ ]*))\s*"
    r"(all-gather|all-reduce|reduce-scatter|all-to-all|collective-permute)"
    r"[^a-z]", re.IGNORECASE)
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        b = _DTYPE_BYTES.get(dt)
        if b is None:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * b
    return total


def collective_bytes(hlo_text: str) -> Dict[str, int]:
    """Per-device wire bytes per collective kind from compiled HLO."""
    out: Dict[str, int] = {}
    for m in _COLL_RE.finditer(hlo_text):
        shape_str, kind = m.group(1), m.group(2).lower()
        b = _shape_bytes(shape_str)
        if kind == "all-reduce":
            b *= 2          # RS + AG phases on the wire
        out[kind] = out.get(kind, 0) + b
    return out


@dataclass
class Roofline:
    """The terms of one cell; ``collective_s`` and the collective bytes
    are ``None`` where no HLO says them (every cell of the port)."""
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    flops_per_device: float
    bytes_per_device: float
    coll_bytes_per_device: Optional[float]
    coll_breakdown: Optional[Dict[str, int]]
    measured_s: Optional[float] = None
    notes: Dict[str, str] = field(default_factory=dict)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        terms = {k: v for k, v in terms.items() if v is not None}
        return max(terms, key=terms.get)

    def model_flops_ratio(self, model_flops_global: float, chips: int
                          ) -> float:
        hlo_global = self.flops_per_device * chips
        return model_flops_global / hlo_global if hlo_global else 0.0

    def share_of_measured(self) -> Optional[Dict[str, float]]:
        """Each analytic term over the measured step's seconds (``None``
        with no measurement)."""
        if not self.measured_s:
            return None
        return {"compute": self.compute_s / self.measured_s,
                "memory": self.memory_s / self.measured_s}


def analyze(cfg, shape, chips: int = 1,
            measured_s: Optional[float] = None) -> Roofline:
    """The roofline of one (arch x shape) cell spread over ``chips``:
    compute and memory from :func:`~repro_torch.launch.analytic.step_cost`
    at the H100's bf16 and HBM rates, the collective term ``None``
    (:data:`NO_HLO`), and ``measured_s`` (a timed step on the card)
    beside them."""
    from .analytic import step_cost
    est = step_cost(cfg, shape)
    flops, mem_bytes = est.flops / chips, est.hbm_bytes / chips
    return Roofline(
        compute_s=flops / H100_PEAK_BF16_FLOPS,
        memory_s=mem_bytes / H100_HBM_BW,
        collective_s=None,
        flops_per_device=flops,
        bytes_per_device=mem_bytes,
        coll_bytes_per_device=None,
        coll_breakdown=None,
        measured_s=measured_s,
        notes={"collective": NO_HLO},
    )


def model_flops(cfg, shape) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE) for train; 2*N_active*B per
    decode token; prefill = forward only (2*N*D)."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch  # decode: one token
