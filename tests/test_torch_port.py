"""Structure of the PyTorch port: it never imports JAX or the reference
package, it never falls back to the CPU unasked, its CLI runs and replays
plans, and the pending knobs and invalid configs raise.
"""

import ast
import json
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.fl.engine import (ExecutionConfig, LocalEngine,
                                   resolve_backend, resolve_device)
from repro_torch.fl.packing import QuantSpec
from repro_torch.fl.stream import StreamConfig
from repro_torch.launch import train
from repro_torch.runtime import RuntimeConfig

SRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_imports_jax_or_the_reference():
    files = sorted(SRC.rglob("*.py"))
    assert len(files) > 20
    bad = [(str(f.relative_to(SRC)), name) for f in files
           for name in _imports(f) if name.split(".")[0] in FORBIDDEN]
    assert bad == []
    root = SRC.parents[1] / "chip_smoke.py"
    assert [n for n in _imports(root) if n.split(".")[0] in FORBIDDEN] == []
    # the new subpackages are covered, and so are the example twins
    assert {"control", "optim", "runtime", "ckpt", "roofline"} <= \
        {f.parent.name for f in files}
    assert {"shapes.py", "dryrun.py", "op_cost.py"} <= \
        {f.name for f in files}
    # a twin keeps its own copy of what it needs from ``benchmarks/``
    # (whose modules import JAX) and never imports it
    twins = sorted((SRC.parents[1] / "examples").glob("*_torch.py"))
    assert len(twins) >= 4
    assert "fl_paper_experiment_torch.py" in {t.name for t in twins}
    assert [(t.name, n) for t in twins for n in _imports(t)
            if n.split(".")[0] in FORBIDDEN + ("benchmarks",)] == []


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalEngine(lambda p, b: 0.0, ExecutionConfig())
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--rounds", "1"])
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("device,fp32", [("cuda", True), ("cpu", False)])
def test_cuda_engine_sets_the_fp32_policy(monkeypatch, device, fp32):
    # building a CUDA engine touches no card, only the process-wide flags
    flags = [(torch.backends.cuda.matmul, "allow_tf32", True),
             (torch.backends.cuda.matmul,
              "allow_bf16_reduced_precision_reduction", True),
             (torch.backends.cudnn, "allow_tf32", True),
             (torch.backends.cudnn, "deterministic", False),
             (torch.backends.cudnn, "benchmark", True)]
    for mod, name, loose in flags:
        monkeypatch.setattr(mod, name, loose)
    LocalEngine(lambda p, b: 0.0, ExecutionConfig(), device=device)
    for mod, name, loose in flags:
        assert getattr(mod, name) == (not loose if fp32 else loose), name


@pytest.mark.parametrize("cfg,exc", [
    (ExecutionConfig(backend="pallas", record_mixed=True, quant=QuantSpec()),
     ValueError),
    (ExecutionConfig(backend="sparse", quant="int8"), ValueError),
    # the SSD family at a 'model' axis above 1 resolves (no exception)
    (ExecutionConfig(mesh=SimpleNamespace(
        shape=(1, 2, 2), mesh_dim_names=("pod", "data", "model")),
        model_cfg=get_config("mamba2-1.3b").reduced()), None),
    (ExecutionConfig(stream=StreamConfig(), scan=True), ValueError),
    (ExecutionConfig(backend="aggregate", record_mixed=True), ValueError),
    (ExecutionConfig(backend="nope"), ValueError),
    (ExecutionConfig(backend="sparse_aggregate", record_mixed=True),
     ValueError)])
def test_pending_and_invalid_configs_raise(cfg, exc):
    if exc is None:
        assert resolve_backend(cfg) == cfg.backend
        return
    with pytest.raises(exc):
        resolve_backend(cfg)


@pytest.mark.parametrize("cfg,effective", [
    (ExecutionConfig(backend="fused"), "aggregate"),
    (ExecutionConfig(backend="pallas"), "aggregate"),
    (ExecutionConfig(backend="fused", record_mixed=True), "fused"),
    (ExecutionConfig(backend="pallas", record_mixed=True), "pallas"),
    (ExecutionConfig(backend="einsum", record_mixed=True), "einsum"),
    (ExecutionConfig(backend="sparse"), "sparse_aggregate"),
    (ExecutionConfig(backend="sparse", record_mixed=True), "sparse"),
    (ExecutionConfig(backend="sparse_aggregate"), "sparse_aggregate"),
    (ExecutionConfig(backend="fused", quant=QuantSpec()), "aggregate")])
def test_record_mixed_upgrade_matrix(cfg, effective):
    assert resolve_backend(cfg) == effective


@pytest.mark.parametrize("cfg,want", [
    (ExecutionConfig(backend="pallas", stream=StreamConfig()), "aggregate"),
    (ExecutionConfig(backend="fused", stream=StreamConfig()), "aggregate"),
    (ExecutionConfig(backend="einsum", stream=StreamConfig()), "einsum"),
    (ExecutionConfig(backend="aggregate", stream=StreamConfig(),
                     runtime=RuntimeConfig()), "aggregate"),
    (ExecutionConfig(scan=True, stream=StreamConfig()), "scan"),
    (ExecutionConfig(backend="pallas", record_mixed=True,
                     stream=StreamConfig()), "record_mixed"),
    (ExecutionConfig(stream=StreamConfig(), mesh=object()), "mesh"),
    (ExecutionConfig(backend="ring", stream=StreamConfig()), "ring"),
    (ExecutionConfig(backend="sparse", stream=StreamConfig()), "sparse"),
    (ExecutionConfig(backend="sparse_aggregate", stream=StreamConfig()),
     "sparse"),
    (ExecutionConfig(stream=StreamConfig(), quant=QuantSpec()), "quantized"),
    (ExecutionConfig(runtime=RuntimeConfig()), "stream")])
def test_resolve_backend_stream_matrix(cfg, want):
    """The reference's stream matrix: 'pallas'/'fused' resolve to
    'aggregate'; scan, record_mixed, mesh, unknown and sparse backends,
    quant, and a runtime without a stream raise ValueError."""
    if want in ("aggregate", "einsum"):
        assert resolve_backend(cfg) == want
    else:
        with pytest.raises(ValueError, match=want):
            resolve_backend(cfg)


def test_train_cli_runs_and_replays_its_plan(tmp_path, capsys):
    args = ["--device", "cpu", "--model", "logreg", "--rounds", "2",
            "--n", "10", "--clusters", "2", "--k-min", "2", "--k-max", "3",
            "--samples", "200", "--T", "2", "--batch", "4", "--quiet"]
    plan = tmp_path / "plan.json"
    out1, out2 = tmp_path / "a.json", tmp_path / "b.json"
    assert train.main(args + ["--backend", "fused", "--record-mixed",
                              "--dropout", "0.2", "--plan-out", str(plan),
                              "--out", str(out1)]) == 0
    assert "fused backend" in capsys.readouterr().out
    assert train.main(args + ["--backend", "einsum", "--scan",
                              "--plan", str(plan), "--out", str(out2)]) == 0
    a, b = json.loads(out1.read_text()), json.loads(out2.read_text())
    assert a["total_cost"] == b["total_cost"]
    assert [r["d2s"] for r in a["rounds"]] == [r["d2s"] for r in b["rounds"]]
    np.testing.assert_allclose([r["test_loss"] for r in a["rounds"]],
                               [r["test_loss"] for r in b["rounds"]],
                               rtol=1e-5)
