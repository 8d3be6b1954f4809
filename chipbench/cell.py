"""The program's side of a cell: one ``FederatedServer`` built from the
seed, driven a block at a time.

A configuration module (``configs/<name>.py``) subclasses ``FedCell``
and gives the model, the network, the server's settings and the batches;
everything a round does runs in ``repro_torch``.  Each block is one
``FederatedServer.run`` of ``K`` rounds from the seed's initial params,
with a plan built here by the constructor ``run`` itself calls
(``RoundPlan.connectivity_aware``) on its own seed, and batches drawn
from a stream of its own; so every block does the same work, on rows
that all differ.

A traffic that names a ``mesh`` (pod, data, model) runs the program's
mesh runtime: the server's ``ExecutionConfig`` takes the mesh, built
over the run's process group (``launch.mesh.make_debug_mesh``), beside
the configuration's ``execution_extras``; the traffic's ``zero`` reaches
the program only where ``ExecutionConfig`` has that field.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from chipbench import peaks
from chipbench.data import block_seed
from chipbench.harness import change_norms, leaves_by_path

__all__ = ["FedCell", "merged_sizes"]


def merged_sizes(base: Dict, overrides: Optional[Dict]) -> Dict:
    out = dict(base)
    out.update(overrides or {})
    return out


class FedCell:
    """Subclasses set ``PRECISION`` (a key of ``peaks.FLOPS``) and give
    ``make_params``, ``make_network``, ``loss_fn``, ``server_config``,
    ``draw`` (one round's batch and what the reference needs of it),
    ``eval_batch``, ``evaluate`` (the window's evaluation hook's work),
    ``reference_inputs``, ``train_flops_per_round`` and
    ``mix_bytes_per_round``."""

    PRECISION = "fp32"

    def __init__(self, traffic: Dict, seed: int, device: str, sizes: Dict):
        from repro_torch.core.server import FederatedServer
        from repro_torch.fl.engine import ExecutionConfig

        self.traffic, self.seed, self.sizes = traffic, int(seed), sizes
        self.device = torch.device(device)
        self.mesh = None
        self.init = self.make_params()
        self.network = self.make_network()
        extras = self.execution_extras()
        if "mesh" in traffic:
            from repro_torch.launch.mesh import make_debug_mesh
            self.mesh = make_debug_mesh(tuple(traffic["mesh"]),
                                        device=self.device.type)
            extras["mesh"] = self.mesh
            if traffic.get("zero"):
                names = {f.name for f in dataclasses.fields(ExecutionConfig)}
                if "zero" not in names:
                    raise ValueError(
                        "the traffic asks for zero, and the program's "
                        "ExecutionConfig has no such field: its mesh "
                        "runtime cannot be asked for ZeRO")
                extras["zero"] = True
        execution = ExecutionConfig(
            backend=traffic["backend"],
            record_mixed=bool(traffic.get("record_mixed", False)),
            **extras)
        self.server = FederatedServer(
            self.network, self.loss_fn(), self.init, self.sample,
            self.server_config(), algorithm="semidec", execution=execution,
            device=self.device)
        self.check_loss = getattr(self.server.engine, "loss_fn", None)
        if self.check_loss is None:
            # the mesh runtime keeps no loss: the configured model's, on
            # the whole params its hook is given
            from repro_torch.models.model import Model
            self.check_loss = Model(execution.model_cfg,
                                    device=self.device).loss
        self.peak_flops = peaks.FLOPS[self.PRECISION]
        self.failed_rounds = 0
        self._rng: Optional[np.random.Generator] = None
        self._draws: Optional[List[Any]] = None

    def execution_extras(self) -> Dict:
        return {}

    # -- one block ------------------------------------------------------------

    def plan(self, block: int, rounds: int):
        from repro_torch.fl.plan import RoundPlan

        cfg = dataclasses.replace(self.server.config, t_max=rounds,
                                  seed=block_seed(self.seed, 1, block))
        with record_function("chipbench.plan"):
            return RoundPlan.connectivity_aware(self.network, cfg)

    def sample(self, _server_rng, t: int):
        """The server's batch sampler: the block's own stream (the
        server's generator is left unused, so a block's batches follow
        from the seed and the block alone)."""
        batch, draw = self.draw(self._rng)
        if self._draws is not None:
            self._draws.append(draw)
        return batch

    def run_block(self, block: int, plan, hook, draws=None) -> None:
        self._rng = np.random.default_rng(block_seed(self.seed, 2, block))
        self._draws = draws
        self.server.params = self.init
        self.server.run(eval_fn=hook, plan=plan)
        self._draws = None

    def window_hook(self, stamps):
        def hook(p):
            with record_function("chipbench.eval"):
                out = self.evaluate(p)
            stamps.mark()
            return out
        return hook

    # -- the check block ------------------------------------------------

    def run_check_block(self, rounds: int, checked: int, stamps) -> Dict:
        """Block 0: the window's call and feed from the seed's params.
        Records, for its first ``checked`` rounds, the loss of the
        program's params on the eval batch (the program's own loss), the
        change from the initial params by leaf after the first round and
        after the last checked one, the plan's rows and the batches'
        draws."""
        plan = self.plan(0, rounds)
        draws: List[Any] = []
        out: Dict[str, Any] = {"loss": [], "first": None, "final": None}
        window = self.window_hook(stamps)

        def hook(p):
            t = len(out["loss"])
            if t < checked:
                with torch.no_grad():
                    loss = self.check_loss(p, self.eval_batch())
                out["loss"].append(float(loss))
                if t == 0:
                    out["first"] = change_norms(p, self.init)
                if t == checked - 1:
                    out["final"] = change_norms(p, self.init)
            else:
                out["loss"].append(None)
            return window(p)

        self.run_block(0, plan, hook, draws)
        out["loss"] = out["loss"][:checked]
        sub = plan[:checked]
        out["plan"] = {name: np.asarray(getattr(sub, name)) for name in
                       ("A_t", "tau_t", "m_t", "eta_t", "m_planned_t",
                        "m_actual_t", "active_t")}
        out["batches"] = draws[:checked]
        return out

    def free(self) -> None:
        """Drop the program's state before the reference runs."""
        self.server = None
        self.init = None
        self.check_loss = None
        self.mesh = None

    def describe(self) -> str:
        n_params = sum(int(x.numel())
                       for x in leaves_by_path(self.init).values())
        return (f"{self.sizes['name']}: {n_params:,} params, "
                f"{self.train_flops_per_round:.6e} training FLOP a round "
                f"(frozen), {self.mix_bytes_per_round:.6e} ideal bytes of "
                f"mixing and aggregation a round, peak "
                f"{self.peak_flops:.3e} FLOP/s ({self.PRECISION})")


def round_up(x: int, unit: int) -> int:
    return int(math.ceil(x / unit) * unit)
