"""Declarative topology API: pluggable time-varying D2D graph families
(port of ``repro.topology``, every family of the reference registered).

Registered families (see ``families`` for regimes): ``k_regular`` (the
paper's Sec. 6.1.1 model), ``erdos_renyi``, ``geometric``
(time-correlated random-waypoint mobility), ``ring``, ``small_world``,
``hub``, ``preferential_attachment`` (scale-free in-degree tails),
``learned`` (top-k collaboration graph driven by ``set_similarity``) and
``measured_trace`` (replays a recorded edge list).

    spec  = topology.make_spec("geometric", n=70, c=7, radius=0.3)
    model = spec.build()
    plan  = RoundPlan.connectivity_aware(model, cfg)   # spec embedded
    plan.regenerate()                                  # bitwise == plan

CLI syntax: ``topology.parse_spec("ring:hops=1", n=70, c=7)`` (see
``repro_torch.launch.train --topology``).
"""

from .families import (ErdosRenyi, Geometric, Hub, KRegular, Learned,
                       MeasuredTrace, PreferentialAttachment, Ring,
                       SmallWorld)
# imported after .families so the registry *function* ``families`` wins
# over the submodule attribute of the same name
from .base import (MEMBERSHIPS, ClusteredTopology, TopologyModel,
                   TopologySpec, build, families, family_defaults,
                   from_json, make_partition, make_spec, parse_spec,
                   register)

__all__ = [
    "MEMBERSHIPS", "ClusteredTopology", "TopologyModel", "TopologySpec",
    "build", "families", "family_defaults", "from_json", "make_partition",
    "make_spec", "parse_spec", "register",
    "KRegular", "ErdosRenyi", "Geometric", "Ring", "SmallWorld", "Hub",
    "PreferentialAttachment", "Learned", "MeasuredTrace",
]
