"""Three-term roofline of one rank's step (port of ``repro.roofline``)."""

from .op_cost import OpCost, cost_of
from .roofline import (H100, HW, RooflineReport, collective_bytes,
                       model_flops, roofline_report)

__all__ = ["HW", "H100", "RooflineReport", "collective_bytes",
           "roofline_report", "model_flops", "OpCost", "cost_of"]
