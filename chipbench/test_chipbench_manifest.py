"""BENCHMARK.json against the contract's shape, every name found as a
file of its own, and a cell and a metric added without editing a file
that is there."""

import hashlib
import json
import math
import re
import shutil
from pathlib import Path

import pytest

from chipbench import harness

ROOT = Path(__file__).resolve().parents[1]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def manifest():
    return harness.load_manifest(ROOT / "BENCHMARK.json")


def test_manifest_keys_and_names():
    m = manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["command"] == ["python3", "chipbench/run.py"]
    assert m["paths"] == ["chipbench"]
    assert 1 <= m["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in m[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for mt in m["end_to_end"] + m["per_layer"]:
        assert UNIT.match(mt["unit"]) and mt["better"] in ("lower",
                                                           "higher")
    assert {"setup_s"} <= {mt["name"] for mt in m["end_to_end"]}
    for mt in m["end_to_end"]:
        assert mt["source"] in ("host_clock", "device_trace")
        assert 0.01 <= mt["bound"] <= 0.25
    for c in m["configs"] + m["workloads"]:
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    for c in m["configs"]:
        assert 1 <= len(c["source"]) <= 200 and set(c) == {
            "name", "source", "file", "reduced", "why"}
    for c in m["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
    for mt in m["per_layer"]:
        assert 1 <= len(mt["layer"]) <= 200 and "\n" not in mt["layer"]
        # each cell the metric lists reports the metric it moves
        for cell in mt["workloads"]:
            e2e = [x["name"] for x in harness.metrics_for(m, cell, False)]
            assert mt["moves"] in e2e, (mt["name"], cell)
    assert len(json.dumps(m)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads"])
def test_every_entry_has_its_files(kind):
    m = manifest()
    for entry in m[kind]:
        if kind == "configs":
            assert (ROOT / entry["file"]).is_file()
            assert (ROOT / "chipbench" / "configs"
                    / f"{entry['name']}.py").is_file()
            assert (ROOT / "chipbench" / "reference"
                    / f"{entry['name']}.py").is_file()
            sizes = json.loads((ROOT / entry["file"]).read_text())
            assert sizes["name"] == entry["name"]
            assert sizes["source"] == entry["source"]
        else:
            traffic = harness.load_json("workloads", entry["name"])
            assert traffic["config"] == entry["config"]
            assert traffic["traffic"] == entry["traffic"]
            # a mesh covers the cell's chips; a cell without one takes one
            assert entry["chips"] in (1, 4)
            assert math.prod(traffic.get("mesh", [1])) == entry["chips"]
    if kind == "workloads":
        four = sum(c["chips"] == 4 for c in m["workloads"])
        assert four <= max(1, len(m["workloads"]) // 4)


def test_every_metric_has_a_reader_and_every_cell_reports():
    m = manifest()
    for mt in m["end_to_end"] + m["per_layer"]:
        assert callable(harness.load_module("metrics", mt["name"]).read)
    for cell in m["workloads"]:
        e2e = [x["name"] for x in harness.metrics_for(m, cell["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.metrics_for(m, cell["name"], True)


def _digest(root: Path):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_are_added_as_files(tmp_path, monkeypatch):
    """A later PR adds ``workloads/<cell>.json`` and
    ``metrics/<metric>.py`` and entries in BENCHMARK.json; the harness
    finds them by name, and no file that was there changes."""
    bench = tmp_path / "chipbench"
    shutil.copytree(ROOT / "chipbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digest(bench)
    traffic = json.loads((bench / "workloads"
                          / "cnn_paper.aggregate.json").read_text())
    traffic["traffic"] = "paper_aggregate_k10"
    traffic["rounds_per_block"] = 10
    (bench / "workloads" / "cnn_paper.aggregate_k10.json").write_text(
        json.dumps(traffic))
    (bench / "metrics" / "rounds_done.py").write_text(
        "def read(rec):\n    return float(rec.rounds)\n")
    m = manifest()
    m["workloads"].append({"name": "cnn_paper.aggregate_k10",
                           "config": "mcmahan_cnn_paper",
                           "traffic": "paper_aggregate_k10", "chips": 1,
                           "why": "test"})
    m["per_layer"].append({"name": "rounds_done", "unit": "rounds",
                           "better": "higher", "source": "host_clock",
                           "layer": "FL driver", "moves": "round_ms",
                           "workloads": ["cnn_paper.aggregate_k10"]})
    monkeypatch.setattr(harness, "BENCH", bench)
    assert harness.load_json("workloads", "cnn_paper.aggregate_k10")[
        "rounds_per_block"] == 10
    names = [x["name"] for x in
             harness.metrics_for(m, "cnn_paper.aggregate_k10", True)]
    assert "rounds_done" in names
    rec = harness.Record(setup_s=1.0, window_s=1.0, round_ms=[1.0, 2.0],
                         plan_s=0.1, plan_rounds=2, peak_bytes=1,
                         train_flops_per_round=1.0, peak_flops=1.0,
                         mix_bytes_per_round=1.0)
    assert harness.load_module("metrics", "rounds_done").read(rec) == 2.0
    after = _digest(bench)
    assert {k: v for k, v in after.items() if k in before} == before
