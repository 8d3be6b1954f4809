"""Declarative topology API: pluggable time-varying D2D graph families
(port of ``repro.topology``; only ``k_regular`` is registered so far).

    spec  = topology.make_spec("k_regular", n=70, c=7, k_range=(6, 9))
    model = spec.build()
    plan  = RoundPlan.connectivity_aware(model, cfg)   # spec embedded
    plan.regenerate()                                  # bitwise == plan
"""

from .families import KRegular
# imported after .families so the registry *function* ``families`` wins
# over the submodule attribute of the same name
from .base import (MEMBERSHIPS, NOT_YET_PORTED, ClusteredTopology,
                   TopologyModel, TopologySpec, build, families,
                   family_defaults, from_json, make_partition, make_spec,
                   parse_spec, register)

__all__ = [
    "MEMBERSHIPS", "NOT_YET_PORTED", "ClusteredTopology", "TopologyModel",
    "TopologySpec", "build", "families", "family_defaults", "from_json",
    "make_partition", "make_spec", "parse_spec", "register", "KRegular",
]
