"""The port's example twins (``examples/quickstart_torch.py``,
``examples/connectivity_sweep_torch.py``) run on ``--device cpu`` at a
tiny size, and their host-side columns -- m(t), the psi bound, the D2D
counts -- equal the JAX reference's ``RoundPlan.connectivity_aware`` for
the same topology spec and seed (planning is numpy in both packages).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest

from repro import topology as jtopology
from repro.core.server import ServerConfig as JServerConfig
from repro.fl.plan import RoundPlan as JRoundPlan

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _columns(records):
    return ([r.m_actual for r in records], [r.psi_bound for r in records],
            [r.d2d for r in records])


def test_quickstart_twin_matches_the_reference_plan(capsys):
    rounds = 3
    server, history = _load("quickstart_torch").main(
        ["--device", "cpu", "--rounds", str(rounds), "--samples", "600"])
    out = capsys.readouterr().out
    assert "m(t)" in out and "psi bound" in out and "run on cpu" in out
    assert len(history.records) == rounds
    assert all(0.0 <= r.metrics["acc"] <= 1.0 for r in history.records)
    jplan = JRoundPlan.connectivity_aware(
        jtopology.make_spec("k_regular", n=20, c=2, k_range=(6, 9),
                            p_fail=0.1).build(),
        JServerConfig(T=5, t_max=rounds, phi_max=2.0))
    assert _columns(history.records) == (
        jplan.m_actual_t.tolist(), jplan.psi_bound_t.tolist(),
        jplan.d2d_t.tolist())
    assert server.last_plan.to_json() == jplan.to_json()


@pytest.mark.parametrize("families", [
    ["k_regular:k_range=4-5,p_fail=0.1", "ring:hops=1"],
    ["hub:hubs=1", "geometric:radius=0.35,speed=0.08"]])
def test_connectivity_sweep_twin_matches_the_reference_plans(families,
                                                             capsys):
    n, c, rounds = 12, 2, 2
    results = _load("connectivity_sweep_torch").main(
        ["--device", "cpu", "--rounds", str(rounds), "--n", str(n),
         "--clusters", str(c), "--samples", "600", "--families",
         *families])
    out = capsys.readouterr().out
    assert "final acc" in out
    for text in families:
        spec = jtopology.parse_spec(text, n=n, c=c)
        jplan = JRoundPlan.connectivity_aware(
            spec.build(), JServerConfig(T=5, t_max=rounds, phi_max=0.2))
        h = results[spec.family]
        assert _columns(h.records) == (
            jplan.m_actual_t.tolist(), jplan.psi_bound_t.tolist(),
            jplan.d2d_t.tolist())
        assert np.isfinite(h.records[-1].metrics["acc"])
