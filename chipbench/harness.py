"""The benchmark's driver: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration and a traffic mix.  Everything that belongs
to one of them sits in files of its own, found by name:

    chipbench/workloads/<cell>.json     the traffic: backend, rounds a
                                        block, rounds the check follows,
                                        the traced blocks, the limits
    chipbench/configs/<config>.json     the configuration's sizes as run
    chipbench/configs/<config>.py       builds the program's side from the
                                        seed, the frozen FLOP / byte counts
    chipbench/reference/<config>.py     the plain reference of a round
    chipbench/metrics/<metric>.py       each metric's reader: ``read(rec)``

A run (``run_cell``):

1. set-up: the kernels built or loaded, the cell's data and weights made
   from the seed, one ``FederatedServer`` built; the check block, a block
   of the window's own call and feed, run from the seed's params (it
   warms every shape the window uses and records what the reference
   follows);
2. the window: blocks of ``rounds_per_block`` rounds, each one
   ``FederatedServer.run`` with a plan the harness builds
   (``RoundPlan.connectivity_aware``) and the seed's initial params; an
   evaluation hook after every round ends in a device synchronise and
   stamps the host clock; no block starts after ``--seconds``;
3. with ``--trace 1`` a further ``traced_blocks`` blocks under
   ``torch.profiler``, with the program's round functions wrapped in
   spans;
4. the check: the program's state freed, the reference follows the check
   block on the same inputs, and each number compared is printed beside
   its limit.

A cell of ``chips`` N > 1 runs on N ranks, one a card (``ranks.py``),
each running all of the above from the same seed: its traffic names the
``mesh`` (pod, data, model) that the program's mesh runtime
(``repro_torch.fl.distributed``) runs on.  Each stamp then follows a
barrier of every rank, so the clock is the slowest rank's; the peak is
the fullest card's; each rank traces its own blocks and rank 0 merges
the reductions (``trace.merge``).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

from chipbench.ranks import Solo


BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
# where a traced run leaves its reduction (``<cell>.breakdown.json``)
OUT = ROOT / "build" / "chipbench"
# top-level module names no process of the benchmark may hold: JAX and
# the JAX package the port was made from (``repro_torch`` is the port)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
# the program's round functions the traced run wraps in spans: the
# single-host runtime's (``repro_torch.core.rounds``) and, on a mesh, the
# mesh runtime's (``repro_torch.fl.distributed``), under the same names
SPANS = {"chipbench.local_sgd": ("client_deltas",),
         "chipbench.mix_update": ("_mix_and_update",
                                  "_mix_and_update_quant")}
MESH_SPANS = {"chipbench.local_sgd": ("local_sgd",),
              "chipbench.mix_update": ("_mix_and_aggregate",)}

__all__ = ["forbidden_modules", "load_manifest", "load_module",
           "metrics_for", "Record", "run_cell", "calibrate"]


def log(msg: str) -> None:
    print(f"[chipbench] {msg}", flush=True)


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: every
    module loaded), each compared whole: ``repro_torch`` passes,
    ``repro.core`` does not."""
    names = list(sys.modules) if names is None else list(names)
    return sorted({n.split(".")[0] for n in names
                   if n.split(".")[0] in FORBIDDEN})


def load_manifest(path: Path = MANIFEST) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``chipbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    mod_name = f"chipbench.{kind}.{name.replace('.', '_').replace('-', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_json(kind: str, name: str) -> Dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def metrics_for(manifest: Dict, cell: str, trace: bool) -> List[Dict]:
    """The cell's metrics of one kind: ``end_to_end`` with ``--trace 0``,
    ``per_layer`` with ``--trace 1``; a metric with a ``workloads`` list
    is the cell's only where the list names it."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[kind]
            if "workloads" not in m or cell in m["workloads"]]


# ---------------------------------------------------------------------------
# What a run measured: the metric readers' one argument
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Record:
    setup_s: float
    window_s: float                 # host clock, first stamp to last
    round_ms: List[float]           # every round of the window
    plan_s: float                   # host clock around the plans
    plan_rounds: int                # rounds those plans cover
    peak_bytes: int
    train_flops_per_round: float    # frozen (configs/<name>.py)
    peak_flops: float               # peaks.FLOPS[the config's precision]
    mix_bytes_per_round: float      # frozen ideal bytes of the layer
    trace: Optional[Dict] = None    # trace.merge of the ranks' reductions
    traced_rounds: int = 0
    # each card's peak, in rank order: a share of the peak on several
    # cards is of len(rank_peak_bytes) x peak_flops
    rank_peak_bytes: List[int] = dataclasses.field(default_factory=list)
    rank_traces: Optional[List[Dict]] = None   # each rank's reduce_trace

    @property
    def rounds(self) -> int:
        return len(self.round_ms)


def leaves_by_path(tree, prefix: str = "") -> Dict[str, Any]:
    """Leaves of a nested dict / list tree by path, keys in sorted order
    (the port's ``tree_flatten`` order)."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves_by_path(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, c in enumerate(tree):
            out.update(leaves_by_path(c, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def change_norms(params, init) -> Dict[str, float]:
    """Per-leaf ``||params - init||``, the difference and its norm taken
    in float64."""
    a, b = leaves_by_path(params), leaves_by_path(init)
    return {k: float((a[k].double() - b[k].double()).norm()) for k in b}


# ---------------------------------------------------------------------------
# The comparison that decides ``correct``
# ---------------------------------------------------------------------------

# a leaf whose first update in the reference is under this share of the
# median leaf's moves by round-off alone and is left out
DEAD_LEAF = 1e-3


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: each round's loss by its relative gap; the
    first update's and the whole check's change by the worst leaf's gap
    of norms, over the larger of that leaf's reference norm and the
    median live leaf's.  A leaf whose first update in the reference is
    under ``DEAD_LEAF`` of the median leaf's is left out."""
    med_all = statistics.median(ref["first"].values())
    live = [k for k, v in ref["first"].items() if v >= DEAD_LEAF * med_all]

    def worst(key):
        med = statistics.median(ref[key][k] for k in live)
        return max(abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med)
                   for k in live)

    loss = max(abs(p - r) / abs(r) if math.isfinite(p) else math.inf
               for p, r in zip(prog["loss"], ref["loss"]))
    return {"loss_rel": loss, "first_update_rel": worst("first"),
            "change_rel": worst("final")}


# ---------------------------------------------------------------------------
# The host clock around the rounds
# ---------------------------------------------------------------------------

class Stamps:
    """Host-clock stamps taken after each round's evaluation hook, which
    ends in ``sync``: a device synchronise, and on several ranks a
    barrier of all of them after it."""

    def __init__(self, sync: Callable[[], None]):
        self.sync = sync
        self.t: List[float] = []

    def mark(self) -> None:
        self.sync()
        self.t.append(time.perf_counter())


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,"
             "clocks.sm,clocks.max.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def kernel_counters():
    """The port's kernel wrappers by name; each counts its launches in
    ``.launches`` (and the routed ones their routes in ``.routes``)."""
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.mixing import fused, mixing, sparse
    return {"aggregate": fused.aggregate_cuda,
            "mix_aggregate": fused.mix_aggregate_cuda,
            "mix": mixing.mix_cuda,
            "sparse_mix": sparse.sparse_mix_cuda,
            "sparse_mix_aggregate": sparse.sparse_mix_aggregate_cuda,
            "aggregate_dequant": fused.aggregate_dequant_cuda,
            "mix_aggregate_dequant": fused.mix_aggregate_dequant_cuda,
            "sparse_mix_aggregate_dequant":
                sparse.sparse_mix_aggregate_dequant_cuda,
            "flash_attention": fa.flash_attention_cuda,
            "flash_attention_bwd": fa.flash_attention_bwd_cuda}


def read_counters(counters) -> Dict:
    out = {}
    for name, f in counters.items():
        if getattr(f, "launches", 0):
            out[name] = {"launches": f.launches}
            if hasattr(f, "routes"):
                out[name]["routes"] = dict(f.routes)
    return out


def reset_counters(counters) -> None:
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "routes"):
            f.routes = dict.fromkeys(f.routes, 0)


class Spans:
    """Wrap the program's round functions in ``record_function`` ranges
    by replacing the module attributes (the round functions look them up
    at call time: ``core.rounds``'s round functions, and the mesh's
    ``train_step``, which reads ``local_sgd`` and ``_mix_and_aggregate``
    from its module's globals); ``restore`` puts them back.  With
    ``mesh`` the mesh runtime's are wrapped too.  A name that is missing
    is reported, and its metrics stay silent."""

    def __init__(self, mesh: bool = False):
        import importlib
        from torch.profiler import record_function

        targets = [("repro_torch.core.rounds", SPANS)]
        if mesh:
            targets.append(("repro_torch.fl.distributed", MESH_SPANS))
        self.saved = []
        self.missing = []
        for mod_name, table in targets:
            mod = importlib.import_module(mod_name)
            for span, attrs in table.items():
                for attr in attrs:
                    fn = getattr(mod, attr, None)
                    if fn is None:
                        self.missing.append(f"{mod_name}.{attr}")
                        continue
                    self.saved.append((mod, attr, fn))

                    def wrapped(*a, _fn=fn, _span=span, **kw):
                        with record_function(_span):
                            return _fn(*a, **kw)

                    setattr(mod, attr, wrapped)

    def restore(self) -> None:
        for mod, attr, fn in self.saved:
            setattr(mod, attr, fn)


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def cell_traffic(manifest: Dict, workload: str, traffic_changes=None):
    """The cell's entry and its traffic (with ``traffic_changes``), held
    to the cell's ``chips``: a ``mesh`` (pod, data, model) covers them
    all, and a cell without one takes one card."""
    cell = next(w for w in manifest["workloads"] if w["name"] == workload)
    traffic = {**load_json("workloads", workload), **(traffic_changes or {})}
    if traffic["config"] != cell["config"]:
        raise ValueError(f"{workload}: BENCHMARK.json names config "
                         f"{cell['config']}, its traffic file "
                         f"{traffic['config']}")
    chips = int(cell["chips"])
    mesh = traffic.get("mesh")
    if (math.prod(mesh) if mesh else 1) != chips:
        raise ValueError(f"{workload}: {chips} chips but the traffic's mesh "
                         f"is {mesh}: a mesh covers every chip, and a cell "
                         "without one takes one")
    return cell, traffic


def rank_device(device: str, team) -> str:
    """The rank's device: its own card on several ranks."""
    return f"cuda:{team.rank}" if device == "cuda" and team.world > 1 \
        else device


def syncer(cuda: bool, team) -> Callable[[], None]:
    """The card's synchronise, then a barrier of every rank."""
    import torch

    def sync():
        if cuda:
            torch.cuda.synchronize()
        team.barrier()
    return sync


def run_cell(manifest: Dict, workload: str, seed: int, seconds: float,
             trace: bool, *, t_start: float, device: str = "cuda",
             sizes: Optional[Dict] = None, traffic_changes=None,
             team=None) -> Dict:
    """Run ``workload`` once and return the result line's dict (the
    checks last).  ``sizes`` and ``traffic_changes`` override the
    configuration's sizes and the traffic's parameters (the CPU tests'
    small shapes).  ``team`` (``ranks.Team``): this process's rank of a
    cell on several; every rank calls this with the same arguments and
    gets the same result."""
    import torch

    team = team or Solo()
    cell, traffic = cell_traffic(manifest, workload, traffic_changes)
    if team.world != int(cell["chips"]):
        raise ValueError(f"{workload} takes {cell['chips']} chips, the run "
                         f"has {team.world} ranks")
    config = load_module("configs", cell["config"])
    reference = load_module("reference", cell["config"])
    cuda = device == "cuda"
    device = rank_device(device, team)
    lead = team.rank == 0
    sync = syncer(cuda, team)
    marks = {"imports": time.perf_counter() - t_start}

    if cuda:
        from repro_torch.kernels import _build
        t0 = time.perf_counter()
        torch.cuda.init()
        _build.build_all()
        marks["kernels"] = time.perf_counter() - t0
        log(f"kernels built or loaded in {marks['kernels']:.3f} s "
            f"({_build.BUILD_DIR.relative_to(ROOT)})")
    t0 = time.perf_counter()
    bench = config.build(traffic, seed, device, sizes)
    sync()
    marks["data_weights_server"] = time.perf_counter() - t0
    counters = kernel_counters()
    policy = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
              "cudnn.deterministic": torch.backends.cudnn.deterministic,
              "cudnn.benchmark": torch.backends.cudnn.benchmark}
    log(f"{workload}: {bench.describe()}; precision policy found after the "
        f"engine's set-up: {policy}; effective backend "
        f"{bench.server.effective_backend}"
        + (f"; mesh {traffic['mesh']}, rank {team.rank} of {team.world}"
           if team.world > 1 else ""))

    K = int(traffic["rounds_per_block"])
    R = int(traffic["check_rounds"])

    # -- the check block: the window's call and feed, from the seed ------
    stamps = Stamps(sync)
    t0 = time.perf_counter()
    check_rec = bench.run_check_block(max(K, R), R, stamps)
    sync()
    marks["check_block"] = time.perf_counter() - t0

    # -- the window --------------------------------------------------------
    def run_block(block: int, hook):
        t0 = time.perf_counter()
        plan = bench.plan(block, K)
        plan_s = time.perf_counter() - t0
        bench.run_block(block, plan, hook)
        return plan_s

    reset_counters(counters)
    if cuda:
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
    smi_before = nvidia_smi() if cuda and lead else "cpu"
    stamps = Stamps(sync)
    team.barrier()
    stamps.t.append(time.perf_counter())
    setup_s = stamps.t[0] - t_start
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in marks.items()))
    plan_s, block = 0.0, 0
    hook = bench.window_hook(stamps)
    # rank 0's clock decides when the window closes, for every rank
    while block == 0 or team.agree(stamps.t[-1] - stamps.t[0] < seconds):
        plan_s += run_block(1 + block, hook)     # block 0 is the check's
        block += 1
    window_s = stamps.t[-1] - stamps.t[0]
    round_ms = [(b - a) * 1e3 for a, b in zip(stamps.t, stamps.t[1:])]
    rank_peaks = team.gather(torch.cuda.max_memory_allocated() if cuda
                             else 0)
    peak = max(rank_peaks)
    launches = read_counters(counters)
    log(f"window: {block} blocks of {K} rounds, {len(round_ms)} rounds in "
        f"{window_s:.6f} s; kernel launches in the window {launches}")
    if team.world > 1:
        log(f"peak bytes by rank: {rank_peaks}")
    if lead:
        log(f"card during the window: before [{smi_before}] after "
            f"[{nvidia_smi() if cuda else 'cpu'}]")

    # -- the traced blocks -------------------------------------------------
    reduced = rank_traces = None
    traced_rounds = 0
    if trace:
        from chipbench import trace as trace_mod
        mine, traced_rounds = _traced(
            bench, run_block, 1 + block, int(traffic["traced_blocks"]), sync,
            mesh="mesh" in traffic)
        rank_traces = team.gather(mine)
        reduced = trace_mod.merge(rank_traces)
        if lead:
            OUT.mkdir(parents=True, exist_ok=True)
            extra = {"ranks": rank_traces} if team.world > 1 else {}
            with open(OUT / f"{workload}.breakdown.json", "w") as f:
                json.dump({"seed": seed, **reduced, **extra}, f, indent=1)

    # -- the check ------------------------------------------------------
    bench.free()
    del hook
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ref = reference.follow(bench.reference_inputs(), check_rec["plan"],
                           check_rec["batches"], device,
                           precision=traffic.get("reference_precision",
                                                 "fp32"))
    log(f"reference followed {R} rounds in {time.perf_counter() - t0:.3f} s")
    numbers = {"plan_violations": float(ref["plan_violations"])}
    numbers.update(compare(check_rec, ref))
    limits = dict(traffic["limits"])
    unlimited = {k: v for k, v in numbers.items() if k not in limits}
    if unlimited:
        log(f"read, not compared (no limit in the traffic file): "
            f"{unlimited}")
    numbers = {k: numbers[k] for k in limits}
    correct = all(numbers[k] <= limits[k] for k in numbers)

    rec = Record(setup_s=setup_s, window_s=window_s, round_ms=round_ms,
                 plan_s=plan_s, plan_rounds=block * K, peak_bytes=peak,
                 train_flops_per_round=bench.train_flops_per_round,
                 peak_flops=bench.peak_flops,
                 mix_bytes_per_round=bench.mix_bytes_per_round,
                 trace=reduced, traced_rounds=traced_rounds,
                 rank_peak_bytes=rank_peaks, rank_traces=rank_traces)
    metrics = {}
    for m in metrics_for(manifest, workload, trace):
        value = load_module("metrics", m["name"]).read(rec)
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run, left out")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": team.world, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(round_ms),
              "failed": int(bench.failed_rounds), "metrics": metrics,
              "device": dev}
    if reduced is not None:
        # averaged over the cards, as the result's ``device`` takes them
        dev["busy_s"] = statistics.fmean(t["busy_s"] for t in rank_traces)
        dev["window_s"] = statistics.fmean(t["window_s"]
                                           for t in rank_traces)
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in numbers}
    return result


def _traced(bench, run_block, first_block: int, n_blocks: int, sync, *,
            mesh: bool = False):
    """Run ``n_blocks`` more blocks under ``torch.profiler`` with the
    round functions in spans; returns this rank's
    ``(reduce_trace(...), rounds)``."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from chipbench import trace as trace_mod

    spans = Spans(mesh)
    if spans.missing:
        log(f"span targets missing: {spans.missing}; their metrics stay "
            f"silent")
    stamps = Stamps(sync)
    hook = bench.window_hook(stamps)
    try:
        sync()
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function(trace_mod.STRETCH):
                for b in range(n_blocks):
                    with record_function("chipbench.block"):
                        run_block(first_block + b, hook)
    finally:
        spans.restore()
    path = Path(tempfile.gettempdir()) / \
        f"chipbench-{os.getpid()}.trace.json"
    t0 = time.perf_counter()
    prof.export_chrome_trace(str(path))
    try:
        reduced = trace_mod.reduce_trace(str(path), list(SPANS))
    finally:
        size = path.stat().st_size
        path.unlink()
    log(f"trace: {size} bytes, reduced in {time.perf_counter() - t0:.3f} "
        f"s; {reduced['n_device_events']} device events summing to "
        f"{reduced['device_sum_s']:.6f} s, busy {reduced['busy_s']:.6f} s "
        f"of {reduced['window_s']:.6f} s; by stream {reduced['streams']}; "
        f"{reduced['unlaunched']} have no launch found; spans "
        f"found {reduced['span_count']}, their device s "
        f"{reduced['span_device_s']}; collectives "
        f"{reduced['collective_s']:.6f} s, exposed "
        f"{reduced['collective_exposed_s']:.6f} s; the program's ranges "
        f"{reduced['program_spans']}")
    return reduced, len(stamps.t)


# ---------------------------------------------------------------------------
# Readings for the limits: the program, its control and its faults
# ---------------------------------------------------------------------------

def calibrate(manifest: Dict, workload: str, seeds: List[int], mode: str,
              *, device: str = "cuda", sizes: Optional[Dict] = None,
              traffic_changes=None, team=None):
    """For each seed: set-up and the check block as a run makes them (no
    window), then the numbers ``run_cell`` compares.  ``mode``:
    ``program`` (the program as it is), ``control`` (the reference at the
    traffic's ``control_precision`` in the program's place, on the
    program's plan and the same batches), or a fault of
    ``chipbench.faults`` planted in the program.  Yields one dict a
    seed, with each leaf's norms.  ``team`` as ``run_cell``'s."""
    import torch
    from chipbench import faults

    team = team or Solo()
    cell, traffic = cell_traffic(manifest, workload, traffic_changes)
    config = load_module("configs", cell["config"])
    reference = load_module("reference", cell["config"])
    R = int(traffic["check_rounds"])
    mesh = "mesh" in traffic
    cuda = device == "cuda"
    device = rank_device(device, team)
    sync = syncer(cuda, team)
    if cuda:
        from repro_torch.kernels import _build
        _build.build_all()
    for seed in seeds:
        t0 = time.perf_counter()
        bench = config.build(traffic, seed, device, sizes)
        if mode in faults.names(mesh):
            with faults.planted(mode, mesh=mesh):
                rec = bench.run_check_block(R, R, Stamps(sync))
        else:
            rec = bench.run_check_block(R, R, Stamps(sync))
        inputs = bench.reference_inputs()
        bench.free()
        del bench
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        got = rec
        if mode == "control":
            got = reference.follow(inputs, rec["plan"], rec["batches"],
                                   device,
                                   precision=traffic["control_precision"])
        ref = reference.follow(inputs, rec["plan"], rec["batches"], device,
                               precision=traffic.get("reference_precision",
                                                     "fp32"))
        numbers = {"plan_violations": float(ref["plan_violations"])}
        numbers.update(compare(got, ref))
        yield {"seed": seed, "mode": mode, "numbers": numbers,
               "loss_prog": got["loss"], "loss_ref": ref["loss"],
               "leaves": {k: [got["first"][k], ref["first"][k],
                              got["final"][k], ref["final"][k]]
                          for k in ref["first"]},
               "plan_messages": ref.get("plan_messages", []),
               "seconds": time.perf_counter() - t0}
