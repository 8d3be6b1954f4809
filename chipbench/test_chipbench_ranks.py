"""A cell on several ranks, on the CPU: four gloo ranks, started as
``run.py`` starts them (``ranks.lead`` / ``ranks.follow``), run the LM
cell's mesh twin through ``run_cell`` at small shapes -- mesh (1, 2, 2),
``ring``, 2 clients in 1 cluster, a manifest whose cell takes 4 chips --
and the mesh's faults through ``calibrate``; and a rank that raises ends
the run non-zero, leaving no process behind.

Each case starts the ranks once: this file run as a script,
``python chipbench/test_chipbench_ranks.py lead OUT MODE``."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve()
ROOT = HERE.parents[1]
CELL = "stablelm2.fedtrain_4k"
WORLD = 4
SIZES = {"hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 4, "intermediate_size": 128,
         "vocab_size": 256, "num_hidden_layers": 1, "seq_len": 32,
         "local_steps": 2, "loss_chunk": 16, "attn_chunk": 16,
         "torch_dtype": "float32", "n_clients": 2, "clusters": 1,
         "k_min": 1, "k_max": 1}
TRAFFIC = {"mesh": [1, 2, 2], "backend": "ring", "rounds_per_block": 2}
RUN_S = 150


# ---------------------------------------------------------------------------
# the ranks (this file run as a script)
# ---------------------------------------------------------------------------

def _body(out: Path, mode: str):
    def body(team):
        import torch
        from chipbench import faults, harness

        torch.set_num_threads(1)
        harness.OUT = out
        manifest = harness.load_manifest()
        for w in manifest["workloads"]:
            if w["name"] == CELL:
                w["chips"] = WORLD
        if mode == "raise" and team.rank == 2:
            from repro_torch.fl import distributed

            def broken(*a, **kw):
                raise RuntimeError("a fault planted in rank 2")
            distributed._mix_and_aggregate = broken
        result = harness.run_cell(
            manifest, CELL, 7, 0.0, True, t_start=time.perf_counter(),
            device="cpu", sizes=SIZES, traffic_changes=TRAFFIC, team=team)
        readings = {}
        for fault in faults.names(mesh=True):
            line, = harness.calibrate(
                manifest, CELL, [11], fault, device="cpu", sizes=SIZES,
                traffic_changes=TRAFFIC, team=team)
            readings[fault] = line["numbers"]
        try:
            harness.load_module("configs", "stablelm2_1_6b").build(
                {**harness.cell_traffic(manifest, CELL, TRAFFIC)[1],
                 "zero": True}, 3, "cpu", SIZES)
            zero = None
        except ValueError as e:
            zero = str(e)
        return {"result": result, "faults": readings, "zero": zero}
    return body


def _main(argv) -> int:
    from chipbench import ranks

    out, mode = Path(argv[1]), argv[2]
    if "--rank" in argv:
        opt = dict(zip(argv[3::2], argv[4::2]))
        return ranks.follow(int(opt["--rank"]), int(opt["--world"]),
                            opt["--store"], int(opt["--parent"]), "cpu",
                            _body(out, mode))
    got = ranks.lead(WORLD, [sys.executable, str(HERE), *argv[:3]], "cpu",
                     _body(out, mode))
    (out / "result.json").write_text(json.dumps(got))
    return 0


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def _launch(tmp_path, mode):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    env["OMP_NUM_THREADS"] = "1"
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, str(HERE), "lead", str(tmp_path),
                          mode], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=RUN_S)
    return out, time.perf_counter() - t0


def _alive(token: str):
    """The live processes whose command line holds ``token``."""
    found = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            cmd = (d / "cmdline").read_bytes().replace(b"\0", b" ")
        except OSError:
            continue
        if token.encode() in cmd:
            found.append((d.name, cmd[:200]))
    return found


def test_four_ranks_run_the_mesh_twin(tmp_path):
    from chipbench import harness

    out, _ = _launch(tmp_path, "run")
    assert out.returncode == 0, out.stderr[-4000:]
    got = json.loads((tmp_path / "result.json").read_text())
    res = got["result"]
    assert res["correct"] is True, res["checks"]
    assert res["device"]["count"] == WORLD
    assert res["attempted"] >= TRAFFIC["rounds_per_block"]
    assert list(res)[-1] == "checks"
    # the mesh runtime's functions are in the harness's spans, on every
    # rank (a CPU run has no device time to give them)
    bd = json.loads((tmp_path / f"{CELL}.breakdown.json").read_text())
    assert len(bd["ranks"]) == WORLD
    for r in bd["ranks"]:
        assert r["span_count"] == {"chipbench.local_sgd": 2,
                                   "chipbench.mix_update": 2}
        assert r["collective_s"] == r["collective_exposed_s"] == 0
    assert {"local_sgd_ms.lm", "mix_update_ms.lm"} <= set(res["metrics"])
    assert "peak bytes by rank: [0, 0, 0, 0]" in out.stdout
    # ranks > 0 log to standard error, each under its rank
    for r in range(1, WORLD):
        assert f"[rank {r}] [chipbench] window:" in out.stderr
    assert "[rank" not in out.stdout
    limits = harness.load_json("workloads", CELL)["limits"]
    for fault, numbers in got["faults"].items():
        assert any(numbers[k] > v for k, v in limits.items()), \
            (fault, numbers)
    assert "ExecutionConfig has no such field" in got["zero"]
    assert _alive(str(tmp_path)) == []


def test_a_failing_rank_ends_the_run(tmp_path):
    from chipbench import ranks

    out, seconds = _launch(tmp_path, "raise")
    assert out.returncode != 0
    assert seconds < ranks.TIMEOUT_S
    assert "a fault planted in rank 2" in out.stderr
    assert not (tmp_path / "result.json").exists()
    assert _alive(str(tmp_path)) == []


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    raise SystemExit(_main(sys.argv[1:]))
