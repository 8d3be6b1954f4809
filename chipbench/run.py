"""Run one cell of the benchmark once:

    python chipbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds the program (``src/repro_torch``)
and ``BENCHMARK.json``.  Prints progress and the card's state on earlier
lines, the numbers compared with their limits as the last lines of
standard error, and the result as one JSON object on the last line of
standard output.  Exits non-zero, printing no result, without a CUDA
card, where the program is missing, or where JAX or the JAX package
(``repro``) has been loaded.

    python chipbench/run.py --workload <cell> --calibrate MODE \
        --seeds 1,2,3

reads, without a window, the numbers the check compares on each seed:
``program``, ``control`` (the reference in a lower precision in the
program's place) or a fault (``chipbench/faults.py``); their lines set
the limits in ``chipbench/workloads/<cell>.json``.

A cell of ``chips`` N > 1 runs on N processes, one a card: this one is
rank 0, builds the kernels, then starts ranks 1 .. N-1 as this command
with ``--rank``, ``--world``, ``--store`` and ``--parent`` added
(``chipbench/ranks.py``); only rank 0 prints the result.
"""

import time

T_START = time.perf_counter()

import argparse    # noqa: E402
import json        # noqa: E402
import os          # noqa: E402
import sys         # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _fail(msg: str, code: int = 2) -> "NoReturn":
    print(f"[chipbench] {msg}", file=sys.stderr, flush=True)
    raise SystemExit(code)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--calibrate", default="")
    ap.add_argument("--seeds", default="")
    # a rank > 0 of a cell on several cards (ranks.lead adds them)
    for name, kind in (("--rank", int), ("--world", int), ("--store", str),
                       ("--parent", int)):
        ap.add_argument(name, type=kind, default=None,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    # build and kernel caches inside the checkout, at fixed paths (the
    # port's own CUDA builds go to build/repro_torch_kernels)
    cache = ROOT / "build" / "chipbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch
    manifest_path = ROOT / "BENCHMARK.json"
    if not manifest_path.is_file():
        _fail(f"no {manifest_path.name} at {ROOT}")
    manifest = json.loads(manifest_path.read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if args.workload not in cells:
        _fail(f"unknown workload {args.workload!r}; cells: {sorted(cells)}")
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available():
        _fail("no CUDA device: the benchmark measures the card and never "
              "falls back to the CPU")
    if torch.cuda.device_count() < chips:
        _fail(f"{args.workload} needs {chips} cards, "
              f"{torch.cuda.device_count()} present")
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        _fail(f"the program is not here ({e}): run from the root of a "
              "checkout of the repository")
    from chipbench import harness

    def body(team=None):
        if args.calibrate:
            seeds = [int(s) for s in args.seeds.split(",") if s]
            for line in harness.calibrate(manifest, args.workload, seeds,
                                          args.calibrate, team=team):
                if team is None or team.rank == 0:
                    print(json.dumps(line), flush=True)
            return None
        return harness.run_cell(manifest, args.workload, args.seed,
                                args.seconds, bool(args.trace),
                                t_start=T_START, team=team)

    if chips == 1:
        out = body()
        found = harness.forbidden_modules()
        if found:
            _fail(f"forbidden modules loaded: {found}", 3)
    else:
        from chipbench import ranks
        if args.rank is not None:
            return ranks.follow(args.rank, args.world, args.store,
                                args.parent, "cuda", body)
        from repro_torch.kernels import _build
        _build.build_all()      # once, before any other rank loads them
        cmd = [sys.executable, str(Path(__file__).resolve()),
               *(sys.argv[1:] if argv is None else argv)]
        out = ranks.lead(chips, cmd, "cuda", body)

    if args.calibrate:
        return 0
    result = out
    sys.stdout.flush()
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
