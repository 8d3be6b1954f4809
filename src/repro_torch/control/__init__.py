"""Online connectivity control: closed-loop planning over D2D rounds (port of
``repro.control``; numpy only).

The open-loop planner (``repro_torch.fl.plan``) fixes every column of the
trajectory before round 0.  This package puts a *policy* in the loop:
once per round a registered ``Controller`` observes what actually
materialized -- the realized topology draw's per-cluster connectivity,
the previous round's ``RoundRecord`` -- and decides the round's client
budget ``m``, D2D gossip depth ``tau``, relay scheme, and (optionally)
step size.  The ``ControlLoop`` realizes decisions into ordinary
``PlanRow``s, so the engines execute controlled rounds through the very
same compiled round function as planned ones, and ``emit_plan()`` turns
any controlled run into a replayable ``RoundPlan`` artifact.

Registered policies (``repro_torch.control.controllers``):

    static       the open-loop eq.-7 rule, verbatim (bitwise pin)
    threshold    eq.-7 re-solved each round on *realized* exact phi
    similarity   Dada-style learned collaboration graph (drives the
                 ``learned`` topology family via delta similarity)

CLI: ``repro_torch.launch.train --controller threshold:phi_max=0.2``.
"""

from .base import (Controller, ControllerSpec, Decision, RealizedRound,
                   build, controller_defaults, controllers, from_json,
                   make_spec, parse_spec, register)
from .controllers import Similarity, Static, Threshold
from .loop import ControlLoop

# importing the .controllers submodule rebinds the package attribute of
# the same name; restore the registry accessor it shadowed
from .base import controllers  # noqa: F811

__all__ = [
    "Controller", "ControllerSpec", "Decision", "RealizedRound",
    "ControlLoop",
    "build", "controller_defaults", "controllers", "from_json",
    "make_spec", "parse_spec", "register",
    "Static", "Threshold", "Similarity",
]
