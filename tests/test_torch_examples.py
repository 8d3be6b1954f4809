"""The port's example twins (``examples/quickstart_torch.py``,
``examples/connectivity_sweep_torch.py``,
``examples/fl_paper_experiment_torch.py``) run on ``--device cpu`` at a
tiny size, and their host-side columns -- m(t), the psi bound, the D2D
counts -- equal the JAX reference's ``RoundPlan.connectivity_aware`` for
the same topology spec and seed (planning is numpy in both packages).
The paper-experiment twin's rows are held against the reference's own
experiment, ``benchmarks/comm_cost.run``.
"""

import importlib.util
import math
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import topology as jtopology
from repro.core.server import ServerConfig as JServerConfig
from repro.fl.plan import RoundPlan as JRoundPlan

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmarks import comm_cost  # noqa: E402


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


# the paper experiment's test set holds samples // 4 = 1,750 points: its
# accuracies may differ by three predictions between the packages (fp32
# local SGD summed in another order moves a logit near a tie)
PAPER_ACC_TOL = 3 / 1750
# the columns the plan and the packed layout decide alone: bitwise
PAPER_PLAN_KEYS = ("total_d2s", "total_d2d", "total_cost", "mean_m",
                   "payload_bytes_per_upload", "uplink_bytes")
PAPER_RUNS = ["semidec", "semidec-exact", "semidec-int8", "fedavg",
              "colrel"]


def _record_targets(monkeypatch, mod, seen):
    """Wrap ``mod._cost_at_accuracy`` to keep each run's per-round test
    accuracies and the matched-accuracy target it was given."""
    inner = mod._cost_at_accuracy

    def recorded(history, target):
        seen.append(([r.metrics["test_acc"] for r in history.records],
                     target))
        return inner(history, target)

    monkeypatch.setattr(mod, "_cost_at_accuracy", recorded)


@pytest.mark.parametrize("case,model", [("high", "mlp"), ("low", "mlp"),
                                        ("high", "logreg")])
def test_paper_experiment_twin_matches_comm_cost(case, model, monkeypatch,
                                                 capsys):
    twin = _load("fl_paper_experiment_torch")
    ref_seen, port_seen = [], []
    _record_targets(monkeypatch, comm_cost, ref_seen)
    _record_targets(monkeypatch, twin, port_seen)
    want = comm_cost.run(case=case, rounds=2, model=model, quiet=True)
    if model == "mlp":
        got = twin.main(["--device", "cpu", "--case", case, "--model",
                         model, "--rounds", "2"])
    else:
        got = twin.run(case=case, rounds=2, model=model, device="cpu")
    out = capsys.readouterr().out
    assert all(f"[{case}] {name}" in out for name in PAPER_RUNS)
    if model == "mlp":
        assert "summary" in out and "Algorithm 1 total cost" in out
    assert [r["algorithm"] for r in got] == PAPER_RUNS
    assert [r["algorithm"] for r in want] == PAPER_RUNS
    assert len(port_seen) == len(ref_seen) == len(PAPER_RUNS)
    compared = 0
    for g, w, (accs_p, target_p), (accs_r, target_r) in zip(
            got, want, port_seen, ref_seen):
        assert g.keys() == w.keys()
        assert g["case"] == case
        for key in PAPER_PLAN_KEYS:
            assert g[key] == w[key], (g["algorithm"], key, g[key], w[key])
            assert type(g[key]) is type(w[key]), key
        d = abs(g["final_acc"] - w["final_acc"])
        print(f"{case} {model} {g['algorithm']}: |final_acc - reference| "
              f"{d:.6f} ({round(d * 1750)} of 1,750 predictions; allowed "
              f"{PAPER_ACC_TOL:.6f})")
        assert d <= PAPER_ACC_TOL, g["algorithm"]
        # the matched-accuracy columns are decided by which side of the
        # target each round's accuracy lies: compared where every round of
        # both packages lies further than the tolerance from its target
        if all(abs(a - target_p) > PAPER_ACC_TOL for a in accs_p) and \
                all(abs(a - target_r) > PAPER_ACC_TOL for a in accs_r):
            compared += 1
            assert g["rounds_to_matched_acc"] == w["rounds_to_matched_acc"]
            assert g["cost_at_matched_acc"] == w["cost_at_matched_acc"] \
                or (math.isnan(g["cost_at_matched_acc"])
                    and math.isnan(w["cost_at_matched_acc"]))
    print(f"{case} {model}: {compared} of {len(got)} rows' matched-"
          "accuracy columns compared")
    assert compared >= 1, "no row far enough from the target to compare"


def test_paper_experiment_twin_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    twin = _load("fl_paper_experiment_torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.main(["--model", "mlp", "--rounds", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        twin.experiment()
