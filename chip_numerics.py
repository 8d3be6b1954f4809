#!/usr/bin/env python3
"""Where the LM training cell's bf16 numerics sit, on one CUDA card.

    python3 chip_numerics.py 808,31337,202        # seeds
    python3 chip_numerics.py 808 cpu              # the CPU tests' sizes

For each seed, ``stablelm2.fedtrain_4k``'s check block (its first two
rounds from the seed's params, as a benchmark run makes them) runs on
each of the port's two attention routes: ``kernel`` (bf16 on the card:
the flash kernels, ``models/attention.py::_kernel_route``) and
``plain`` (the query-chunk loop, the route turned off).  The cell's plain
reference (``chipbench/reference``) follows the same plan and batches at
the precision the configuration states (bf16, as ``correct`` compares)
and in fp32.  Each line holds, for every pair, the benchmark's own
numbers (``first_update_rel``, ``change_rel``: the worst leaf's gap of
update norms, ``chipbench/harness.py::compare``), the worst leaf and the
v projection bias's gap, whose gradient, a sum over every token, is the
leaf most sensitive to rounding.  Against fp32 the routes and the bf16
reference can be read side by side: how far each bf16 computation lies
from the function it rounds.
"""

from __future__ import annotations

import gc
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CELL = "stablelm2.fedtrain_4k"
VB = "decoder/layers/attn/v/b"


def _worst(prog, ref, key):
    """(gap, leaf, the v bias's gap): ``compare``'s worst leaf of
    ``key`` ('first' or 'final')."""
    from chipbench.harness import DEAD_LEAF
    med_all = statistics.median(ref["first"].values())
    live = [k for k, v in ref["first"].items() if v >= DEAD_LEAF * med_all]
    med = statistics.median(ref[key][k] for k in live)
    gaps = {k: abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med)
            for k in live}
    leaf = max(gaps, key=gaps.get)
    return gaps[leaf], leaf, gaps.get(VB)


def main(argv) -> int:
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from chipbench import harness
    from repro_torch.models import attention

    seeds = [int(s) for s in argv[0].split(",")]
    device = argv[1] if len(argv) > 1 else "cuda"
    sizes = None
    if device == "cpu":
        from chipbench.test_chipbench_check import CELLS
        sizes = CELLS[CELL]
    cell = next(w for w in harness.load_manifest()["workloads"]
                if w["name"] == CELL)
    traffic = harness.load_json("workloads", CELL)
    config = harness.load_module("configs", cell["config"])
    reference = harness.load_module("reference", cell["config"])
    rounds = int(traffic["check_rounds"])
    sync = (lambda: None) if device == "cpu" else torch.cuda.synchronize
    if device != "cpu":
        from repro_torch.kernels import _build
        _build.build_all()
    kernel_route = attention._kernel_route
    routes = {"kernel": kernel_route, "plain": lambda q: False}
    for seed in seeds:
        runs, inputs = {}, None
        for name, route in routes.items():
            attention._kernel_route = route
            try:
                bench = config.build(traffic, seed, device, sizes)
                runs[name] = bench.run_check_block(rounds, rounds,
                                                   harness.Stamps(sync))
                inputs = inputs or bench.reference_inputs()
                bench.free()
                del bench
            finally:
                attention._kernel_route = kernel_route
            gc.collect()
            if device != "cpu":
                torch.cuda.empty_cache()
        plan, batches = runs["kernel"]["plan"], runs["kernel"]["batches"]
        refs = {p: reference.follow(inputs, plan, batches, device,
                                    precision=p) for p in ("stated", "fp32")}
        pairs = [(f"{r} vs {p}", runs[r], refs[p]) for p in refs
                 for r in runs]
        pairs += [("reference stated vs fp32", refs["stated"], refs["fp32"]),
                  ("kernel vs plain", runs["kernel"], runs["plain"])]
        out = {"seed": seed}
        for label, a, b in pairs:
            f, f_leaf, f_vb = _worst(a, b, "first")
            c, c_leaf, c_vb = _worst(a, b, "final")
            out[label] = {"first_update_rel": f, "first_leaf": f_leaf,
                          "first_v_bias": f_vb, "change_rel": c,
                          "change_leaf": c_leaf, "change_v_bias": c_vb}
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
