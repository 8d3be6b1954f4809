"""No module of the benchmark's runs is JAX or the JAX package, compared
by whole top-level name; and a run refuses to measure without a card."""

import os
import subprocess
import sys
from pathlib import Path

from chipbench import harness

ROOT = Path(__file__).resolve().parents[1]


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules(
        ["repro_torch", "repro_torch.core.rounds", "reproduce", "jax_free",
         "chipbench.reference"]) == []
    assert harness.forbidden_modules(
        ["repro", "repro.core.rounds", "jax.numpy", "jaxlib", "flax.linen",
         "repro_torch"]) == ["flax", "jax", "jaxlib", "repro"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), str(ROOT / "src")])
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_the_run_loads_no_jax_and_refuses_without_a_card():
    """One process imports every module a run loads (the harness, every
    configuration, reference and metric reader, the program's modules a
    cell drives) and finds no forbidden top-level name; then ``run.py``,
    with no card, exits non-zero and prints no result."""
    code = (
        "import json, sys\n"
        "from chipbench import harness, cell, data, faults, trace, peaks\n"
        "from chipbench import ranks\n"
        "from chipbench.reference import precision, plan, algorithm1\n"
        "m = harness.load_manifest()\n"
        "for c in m['configs']:\n"
        "    harness.load_module('configs', c['name'])\n"
        "    harness.load_module('reference', c['name'])\n"
        "for mt in m['end_to_end'] + m['per_layer']:\n"
        "    harness.load_module('metrics', mt['name'])\n"
        "import repro_torch.fl.engine, repro_torch.core.server\n"
        "import repro_torch.models.model, repro_torch.kernels._build\n"
        "import repro_torch.fl.distributed, repro_torch.launch.mesh\n"
        "harness.kernel_counters()\n"
        "print(json.dumps(harness.forbidden_modules()), flush=True)\n"
        "sys.argv = ['run.py', '--workload', 'cnn_paper.aggregate',\n"
        "            '--seed', '5', '--seconds', '1', '--trace', '0']\n"
        "import runpy\n"
        "runpy.run_path('chipbench/run.py', run_name='__main__')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    lines = out.stdout.strip().splitlines()
    assert lines == ["[]"], (out.stdout, out.stderr[-2000:])
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_a_one_card_run_starts_no_rank_and_opens_no_group(tmp_path):
    """``run_cell`` on one card, traced, in a process of its own: nothing
    is started, no process group is made, and the mesh runtime is never
    imported (``torch.distributed`` itself comes with ``import torch``)."""
    code = (
        "import json, subprocess, sys, time\n"
        "started = []\n"
        "class Popen(subprocess.Popen):\n"
        "    def __init__(self, *a, **kw):\n"
        "        started.append(a)\n"
        "        super().__init__(*a, **kw)\n"
        "subprocess.Popen = Popen\n"
        "import torch\n"
        "from chipbench import harness\n"
        "from chipbench.test_chipbench_check import LM_SMALL\n"
        f"harness.OUT = __import__('pathlib').Path({str(tmp_path)!r})\n"
        "res = harness.run_cell(harness.load_manifest(),\n"
        "    'stablelm2.fedtrain_4k', 5, 0.0, True,\n"
        "    t_start=time.perf_counter(), device='cpu', sizes=LM_SMALL)\n"
        "print(json.dumps([res['correct'], res['device']['count'],\n"
        "    len(started), torch.distributed.is_initialized(),\n"
        "    'repro_torch.fl.distributed' in sys.modules]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == \
        "[true, 1, 0, false, false]"
