"""Three-term roofline of one rank's step on an NVIDIA H100 (port of
``repro.roofline.roofline``, whose target is a TPU v5e):

    compute    = FLOPs_per_device       / peak_FLOPs
    memory     = bytes_per_device       / HBM_bw
    collective = sum over mesh axes of that axis's collective bytes per
                 device / the link that axis crosses

The FLOPs, bytes and collectives come from ``op_cost`` (a dispatch-mode
tally of the step, this rank's; the reference reads FLOPs and bytes from
its jaxpr walk and the collectives from the compiled HLO).  The
collective term sums each axis's result bytes over its own link: the
'model' axis inside a node (NVLink), the client axes ('data', 'pod')
across nodes (the network), as ``launch/mesh.py::production_shape`` lays
them out; a group that spans both takes the slower.  The report keeps the
reference's per-kind dict and adds the per-axis split beside it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from repro_torch.models.config import ModelConfig

__all__ = ["HW", "H100", "RooflineReport", "collective_bytes",
           "roofline_report", "model_flops"]


@dataclasses.dataclass(frozen=True)
class HW:
    """Per-card constants; the defaults are the NVIDIA H100 SXM5 80GB's
    published figures (NVIDIA H100 Tensor Core GPU datasheet): dense bf16
    tensor-core rate, HBM3 bandwidth and capacity, NVLink 4 at 900 GB/s
    total, 450 GB/s each way, between the cards of a node, and one
    400 Gb/s (50 GB/s) network port a card (ConnectX-7, as in NVIDIA's
    DGX H100) between nodes."""
    peak_flops: float = 989e12          # bf16 FLOP/s, dense
    hbm_bw: float = 3.35e12             # B/s
    hbm_bytes: float = 80e9             # capacity (context for memory)
    model_link_bw: float = 450e9        # B/s each way, 'model' axis
    client_link_bw: float = 50e9        # B/s a card, client axes

    def link_bw(self, axis: str) -> float:
        """The link a collective over ``axis`` (op_cost's label: mesh
        dims joined by ',') crosses: NVLink for 'model' alone, else the
        network."""
        return self.model_link_bw if axis in ("model", "self") \
            else self.client_link_bw


H100 = HW()


def collective_bytes(cost: Dict[str, Any]) -> Dict[str, int]:
    """Per-collective-kind result bytes of one rank's step, from
    ``op_cost``'s tally (the reference parses them from an optimized
    per-device HLO text; the port has no HLO)."""
    return {k: int(v) for k, v in cost.get("collectives", {}).items()}


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_per_device: Dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops_global: float
    useful_ratio: float                 # MODEL_FLOPS / (FLOPs * chips)
    dominant: str
    peak_memory_bytes: Optional[float] = None
    unknown_loops: int = 0              # always 0: Python loops run unrolled
    collective_per_axis: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    def as_dict(self):
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, kind: str, tokens: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N = active params."""
    n_active = cfg.param_count(active_only=bool(cfg.n_experts))
    per_tok = 6 if kind == "train" else 2
    return float(per_tok * n_active * tokens)


def roofline_report(*, arch: str, shape: str, mesh: str, chips: int,
                    flops_global: float, bytes_global: float,
                    collectives: Dict[str, Any],
                    cfg: ModelConfig, kind: str, tokens: int,
                    peak_memory: Optional[float] = None,
                    hw: HW = H100) -> RooflineReport:
    """``flops_global`` / ``bytes_global``: the step's totals over the
    ``chips`` devices (one rank's tally times ``chips``: every rank runs
    the same program); ``collectives``: one rank's ``op_cost`` tally
    (its ``collectives`` by kind, ``collectives_by_axis`` by axis)."""
    coll = collective_bytes(collectives)
    by_axis = {k: int(v) for k, v in
               collectives.get("collectives_by_axis", {}).items()}
    flops = flops_global / chips
    byts = bytes_global / chips
    mflops = model_flops(cfg, kind, tokens)
    terms = {
        "compute": flops / hw.peak_flops,
        "memory": byts / hw.hbm_bw,
        "collective": sum(b / hw.link_bw(a) for a, b in by_axis.items()),
    }
    dominant = max(terms, key=terms.get)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh, chips=chips,
        flops_per_device=flops, bytes_per_device=byts,
        collective_per_device=coll,
        compute_s=terms["compute"], memory_s=terms["memory"],
        collective_s=terms["collective"],
        model_flops_global=mflops,
        useful_ratio=(mflops / flops_global) if flops_global
        else float("nan"),
        dominant=dominant, peak_memory_bytes=peak_memory,
        unknown_loops=int(collectives.get("unknown_while", 0)),
        collective_per_axis=by_axis)
