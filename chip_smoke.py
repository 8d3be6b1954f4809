#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card; ~4-5 minutes

Phases (each raises on failure; nothing is caught):

1. build   -- compile every ``src/repro_torch/kernels/csrc/*.cu`` with
              ``nvcc`` (one process per source, in parallel) and print
              each kernel's register / shared-memory use from ptxas.
2. kernels -- hold each dense hand-written kernel (aggregate,
              mix_aggregate, mix) against its plain PyTorch version on the
              card: at the
              main path's shapes (70 clients x 1,663,488 packed fp32
              columns for aggregate and mix_aggregate; 70 x each CNN
              leaf's size for mix, which the 'pallas' path launches once
              per leaf) and at ragged bf16 / fp32 shapes.  Print the
              error against its tolerance, the kernel's time (for mix:
              the eight per-leaf launches of one round together), the
              plain version's time, its bound (bytes or fp32 operations
              at the H100's published peaks) and the time of
              ``torch.matmul`` computing the same function.
   sparse  -- the same for the ELL kernels (sparse_mix,
              sparse_mix_aggregate) at four shapes: the ELL of a
              ``k_regular`` plan of the paper's configuration (70 x
              1,663,488 f32, d_max <= 10), an n = 100,000 ``ring`` (12,500
              clusters of 8, d_max = 2, p = 2,048 f32), a ragged ``hub``
              (37 x 1,000, f32 and bf16, d_max = 37) and FedAvg's identity
              (d_max = 1).  Times beside ``torch.sparse.mm`` (CSR x dense)
              as the library yardstick.
3. train   -- Algorithm 1 end to end at full width through
              ``FederatedServer``: n = 70 clients in c = 7 clusters,
              ``k_regular`` k in [6, 9] with p_fail = 0.1, the McMahan
              CNN on 28x28x1 synthetic data, T = 5, batch 32, 3 rounds;
              backends 'fused' (-> the aggregate kernel), 'fused' with
              record_mixed (-> mix_aggregate) and 'pallas' with
              record_mixed (-> mix), 'sparse' (-> the ELL combine row and
              the aggregate kernel) and 'sparse' with record_mixed (->
              sparse_mix_aggregate), each scanned and sequential, against
              the port's plain 'einsum' backend, under the fp32 policy
              the port's engine sets (no TF32, deterministic cuDNN).
              Then eq. 3 alone (``ops.sparse_mix``, -> sparse_mix) on the
              first round's client deltas with the plan's ELL, against
              the dense oracle.  Every kernel's launch count is reset
              before its path and read after it.  Last, one more sequential 'fused' run
              without evaluation is traced with ``torch.profiler``
              (device activity only): the device events by time, one per
              correlation id, and the device's busy share of the traced
              wall time.
4. scale   -- an n = 100,000 ``ring`` plan built sparse (12,500
              clusters of 8), one round of the logreg model (7,850
              params, T = 1, batch 8 drawn from the seed) on 'sparse' and
              on 'sparse' with record_mixed: d2d == n, the two agree, and
              the peak device memory stays far below one (n, n) f32
              array (40 GB).
5. report  -- a ``{"kernels": [...]}`` JSON line, the card's name and
              power limit (nvidia-smi), and the final
              ``{"ok": true, "device": {...}}`` line.

It imports only ``torch``, numpy and ``repro_torch`` (never JAX), and
exits non-zero without a result when no CUDA card is present or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 3          # rounds of Algorithm 1 per training run
SEED = 0            # data, partition, weights and plan

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth and
# the fp32 rate outside the tensor cores -- the kernels run full fp32.
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 1


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms over ``iters`` back-to-back
    calls, by CUDA events after ``warmup`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: int, flops: int):
    """``(bound_ms, bound_by)``: the larger of moving ``nbytes`` at the
    HBM rate and doing ``flops`` fp32 operations at the CUDA-core rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 1 ----------------------------------------------------------------

def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"[build] {len(libs)} kernel librar{'y' if len(libs) == 1 else 'ies'}"
          f" in {time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in libs))
    for lib in libs:
        log = lib.with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "Compiling entry" in line:
                    print(f"[build]   {line.strip()}")


# -- phase 2 ----------------------------------------------------------------

def phase_kernels(n: int, p: int):
    """Each kernel against its plain version; returns the per-kernel
    report rows (launch counts filled in by phase 3)."""
    import torch
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.kernels.mixing import fused, mixing, ref
    from repro_torch.models import cnn

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def inputs(n_, p_, dtype):
        A = torch.rand(n_, n_, generator=g, device=dev)
        A = A / A.sum(0, keepdim=True)             # column-stochastic
        w = torch.rand(n_, generator=g, device=dev) / n_
        X = torch.randn(n_, p_, generator=g, device=dev).to(dtype)
        return A, w, X

    # fp32 sums of <= n products in another order: a few ulps of the
    # row magnitude; bf16 outputs may round one bf16 ulp apart (2^-8 rel).
    tol = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}
    agg_tol = dict(rtol=1e-5, atol=1e-5)

    def err(a, b):
        return float((a.float() - b.float()).abs().max())

    def check(name, got, want, t):
        ok = torch.allclose(got.float(), want.float(), **t)
        e = err(got, want)
        print(f"[kernels]   {name}: max|err| {e:.3e} "
              f"(rtol {t['rtol']:.1e}, atol {t['atol']:.1e})")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return e

    shapes = [(n, p, torch.float32), (37, 100_003, torch.bfloat16),
              (13, 1001, torch.float32), (9, 4096, torch.bfloat16)]
    errs = {"aggregate": 0.0, "mix_aggregate": 0.0, "mix": 0.0}
    for n_, p_, dtype in shapes:
        print(f"[kernels] shape n={n_} p={p_} {dtype}")
        A, w, X = inputs(n_, p_, dtype)
        e = check("aggregate", fused.aggregate_cuda(w, X),
                  ref.aggregate_ref(w, X), agg_tol)
        mixed, agg = fused.mix_aggregate_cuda(A, w, X)
        mixed_r, agg_r = ref.mix_aggregate_ref(A, w, X)
        e2 = max(check("mix_aggregate/mixed", mixed, mixed_r, tol[dtype]),
                 check("mix_aggregate/agg", agg, agg_r, agg_tol))
        e3 = check("mix", mixing.mix_cuda(A, X), ref.mix_ref(A, X),
                   tol[dtype])
        if (n_, p_) == (n, p):       # report the main path's shape
            errs.update(aggregate=e, mix_aggregate=e2)
    # the 'pallas' path launches mix once per CNN leaf: (n, leaf size)
    leaf_p = [int(x.numel()) for x in tree_flatten(cnn.init_cnn(SEED))[0]]
    A, w, X = inputs(n, p, torch.float32)
    leaves = [torch.randn(n, pl, generator=g, device=dev) for pl in leaf_p]
    print(f"[kernels] mix at the {len(leaf_p)} per-leaf shapes n={n} "
          f"p={leaf_p} {torch.float32}")
    errs["mix"] = max(check(f"mix (p={pl})", mixing.mix_cuda(A, x),
                            ref.mix_ref(A, x), tol[torch.float32])
                      for pl, x in zip(leaf_p, leaves))
    torch.cuda.synchronize()

    # timing at the main path's shapes (X is 466 MB: far past the 50 MB L2,
    # so every launch streams it from HBM); mix is one round's launches,
    # one per leaf, timed together
    B = torch.cat([A, w[None]])
    f4 = 4
    leaf_bytes = sum(2 * n * pl * f4 for pl in leaf_p) + n * n * f4
    leaf_flops = sum(2 * n * n * pl for pl in leaf_p)
    rows = []
    specs = [
        ("aggregate", "src/repro/kernels/mixing/fused.py:110",
         lambda: fused.aggregate_cuda(w, X),
         lambda: ref.aggregate_ref(w, X),
         lambda: torch.matmul(w, X),
         n * p * f4 + n * f4 + p * f4, 2 * n * p),
        ("mix_aggregate", "src/repro/kernels/mixing/fused.py:75",
         lambda: fused.mix_aggregate_cuda(A, w, X),
         lambda: ref.mix_aggregate_ref(A, w, X),
         lambda: torch.matmul(B, X),
         2 * n * p * f4 + (n + 1) * n * f4 + p * f4, 2 * (n + 1) * n * p),
        ("mix", "src/repro/kernels/mixing/mixing.py:46",
         lambda: [mixing.mix_cuda(A, x) for x in leaves],
         lambda: [ref.mix_ref(A, x) for x in leaves],
         lambda: [torch.matmul(A, x) for x in leaves],
         leaf_bytes, leaf_flops),
    ]
    for name, replaces, kern, plain, lib, nbytes, flops in specs:
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        lib_ms = cuda_ms(lib)
        b_ms, b_by = bound(nbytes, flops)
        shape = (f"{len(leaf_p)} leaves ({n}, p_leaf)" if name == "mix"
                 else f"({n}, {p})")
        print(f"[kernels] {name} @ {shape} f32: {ms:.4f} ms "
              f"(plain {plain_ms:.4f} ms, torch.matmul {lib_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms by {b_by}: {b_ms / ms:.1%} of it; "
              f"{nbytes / ms / 1e6:.0f} GB/s, {flops / ms / 1e6:.0f} "
              f"GFLOP/s)")
        rows.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/csrc/mixing.cu",
                     "replaces": replaces, "launches": 0,
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": lib_ms})
    packed_ms = cuda_ms(lambda: mixing.mix_cuda(A, X))
    b_ms, _ = bound(2 * n * p * f4 + n * n * f4, 2 * n * n * p)
    print(f"[kernels] mix @ ({n}, {p}) f32, the same bytes in one launch: "
          f"{packed_ms:.4f} ms (bound {b_ms:.4f} ms: {b_ms / packed_ms:.1%} "
          f"of it)")
    del A, w, X, B, leaves
    torch.cuda.empty_cache()
    return rows


def _ell_case(family, n, c, seed, ctor="connectivity_aware",
              **params):
    """Round 0 of a sparse plan: ``(SparseA, tau, m)``."""
    from repro_torch import topology
    from repro_torch.core.server import ServerConfig
    from repro_torch.fl.plan import RoundPlan

    cfg = ServerConfig(T=5, t_max=1, seed=seed, m0=max(1, n // 10),
                       m_fixed=max(1, (4 * n) // 5), bound_kind="general")
    plan = getattr(RoundPlan, ctor)(
        topology.make_spec(family, n=n, c=c, **params).build(), cfg,
        sparse=True)
    return plan.A_t[0], plan.tau_t[0], float(plan.m_t[0])


def phase_sparse_kernels(seed: int):
    """The ELL kernels against their plain versions at the four shapes;
    returns their report rows (main shape: the k_regular plan's ELL at
    the paper's width; launch counts filled in by phase 3)."""
    import torch
    from repro_torch.kernels.mixing import ops, ref, sparse

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    f4 = 4
    tol = {torch.float32: dict(rtol=1e-5, atol=1e-5),
           torch.bfloat16: dict(rtol=2 ** -7, atol=2 ** -7)}
    agg_tol = dict(rtol=1e-5, atol=1e-5)

    def check(name, got, want, t):
        e = float((got.float() - want.float()).abs().max())
        print(f"[sparse]   {name}: max|err| {e:.3e} (rtol {t['rtol']:.1e}, "
              f"atol {t['atol']:.1e})")
        if not torch.allclose(got.float(), want.float(), **t):
            raise AssertionError(f"{name} disagrees with its plain version")
        return e

    cases = [
        ("main: k_regular plan, paper's config", "k_regular", 70, 7,
         1_663_488, torch.float32, "connectivity_aware",
         dict(k_range=(6, 9), p_fail=0.1)),
        ("scale: ring of 12,500 clusters of 8", "ring", 100_000, 12_500,
         2_048, torch.float32, "connectivity_aware", dict(hops=1)),
        ("ragged: hub, one cluster of 37", "hub", 37, 1, 1_000,
         torch.float32, "connectivity_aware", {}),
        ("ragged: hub, one cluster of 37", "hub", 37, 1, 1_000,
         torch.bfloat16, "connectivity_aware", {}),
        ("identity: FedAvg plan", "k_regular", 70, 7, 1_663_488,
         torch.float32, "fedavg", {}),
    ]
    rows, timed = [], {}
    for label, family, n, c, p, dtype, ctor, params in cases:
        A, tau, m = _ell_case(family, n, c, seed, ctor, **params)
        idx_np, w_np = A.ell()
        idx = torch.as_tensor(idx_np, device=dev)
        w = torch.as_tensor(w_np, device=dev)
        wrow = ops.combine_weights_ell(idx, w, torch.as_tensor(
            tau, device=dev), torch.tensor(m, device=dev))
        X = torch.randn(n, p, generator=g, device=dev).to(dtype)
        print(f"[sparse] {label}: n={n} p={p} {dtype} d_max={idx.shape[1]} "
              f"nnz={A.nnz}")
        e1 = check("sparse_mix", sparse.sparse_mix_cuda(idx, w, X),
                   ref.sparse_mix_ref(idx, w, X), tol[dtype])
        mixed, agg = sparse.sparse_mix_aggregate_cuda(idx, w, wrow, X)
        mixed_r, agg_r = ref.sparse_mix_aggregate_ref(idx, w, wrow, X)
        e2 = max(check("sparse_mix_aggregate/mixed", mixed, mixed_r,
                       tol[dtype]),
                 check("sparse_mix_aggregate/agg", agg, agg_r, agg_tol))
        torch.cuda.synchronize()
        del mixed, agg, mixed_r, agg_r
        if label.startswith(("main", "scale", "identity")):
            timed[label.split(":")[0]] = (A, idx, w, wrow, X, e1, e2)
        else:
            del X
    # the identity (d_max = 1) moves the main shape's bytes with one gather
    # a row: beside the main shape it shows what the re-reads of d_max
    # neighbour rows cost
    for which in ("main", "scale", "identity"):
        A, idx, w, wrow, X, e1, e2 = timed.pop(which)
        n, p = X.shape
        nnz = A.nnz
        A_csr = torch.sparse_csr_tensor(
            torch.as_tensor(A.indptr, device=dev),
            torch.as_tensor(A.indices, dtype=torch.int64, device=dev),
            torch.as_tensor(A.data, device=dev), size=(n, n),
            check_invariants=True)
        B_csr = torch.sparse_csr_tensor(   # [A; wrow], wrow a dense row
            torch.as_tensor(list(A.indptr) + [nnz + n], device=dev),
            torch.cat([A_csr.col_indices(),
                       torch.arange(n, device=dev)]),
            torch.cat([A_csr.values(), wrow]), size=(n + 1, n),
            check_invariants=True)
        ell_bytes = idx.numel() * 8
        specs = [
            ("sparse_mix", "src/repro/kernels/mixing/sparse.py:84", e1,
             lambda: sparse.sparse_mix_cuda(idx, w, X),
             lambda: ref.sparse_mix_ref(idx, w, X),
             lambda: torch.sparse.mm(A_csr, X),
             2 * n * p * f4 + ell_bytes, 2 * nnz * p),
            ("sparse_mix_aggregate", "src/repro/kernels/mixing/sparse.py:109",
             e2, lambda: sparse.sparse_mix_aggregate_cuda(idx, w, wrow, X),
             lambda: ref.sparse_mix_aggregate_ref(idx, w, wrow, X),
             lambda: torch.sparse.mm(B_csr, X),
             2 * n * p * f4 + ell_bytes + n * f4 + p * f4,
             2 * nnz * p + 2 * n * p),
        ]
        for name, replaces, e, kern, plain, lib, nbytes, flops in specs:
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain, iters=5)
            lib_ms = cuda_ms(lib, iters=10)
            b_ms, b_by = bound(nbytes, flops)
            print(f"[sparse] {name} @ {which} ({n}, {p}) f32: {ms:.4f} ms "
                  f"(plain {plain_ms:.4f} ms, torch.sparse.mm "
                  f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by}: "
                  f"{b_ms / ms:.1%} of it; {nbytes / ms / 1e6:.0f} GB/s)")
            if which == "main":
                rows.append({"name": name, "route": "cuda",
                             "source": "src/repro_torch/kernels/csrc/"
                                       "sparse_mixing.cu",
                             "replaces": replaces, "launches": 0,
                             "max_abs_err": e, "ms": ms,
                             "plain_ms": plain_ms, "bound_ms": b_ms,
                             "bound_by": b_by, "library_ms": lib_ms})
        del A_csr, B_csr, X
        torch.cuda.empty_cache()
    return rows


# -- phase 3 ----------------------------------------------------------------

def phase_train(rounds: int, seed: int):
    """Algorithm 1 at full width on every kernel backend; returns the
    launch count of each kernel in the path that runs it."""
    import numpy as np
    import torch
    from repro_torch import topology
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                                  make_classification)
    from repro_torch.fl import packing
    from repro_torch.fl.engine import ExecutionConfig
    from repro_torch.kernels.mixing import fused, mixing, sparse
    from repro_torch.models import cnn

    n, c, T, batch = 70, 7, 5, 32
    rng = np.random.default_rng(seed)
    ds = make_classification(n_samples=7000, seed=seed)
    ds_test = make_classification(n_samples=1750, seed=seed + 1)
    parts = label_sorted_partition(ds, n, shards_per_client=2, rng=rng)
    batcher = FederatedBatcher(ds, parts, T=T, batch_size=batch)
    spec = topology.make_spec("k_regular", n=n, c=c, k_range=(6, 9),
                              p_fail=0.1)
    loss_fn = partial(cnn.l2_regularized_loss, cnn.cnn_apply)
    init = cnn.init_cnn(seed)
    n_params = sum(int(x.numel()) for x in tree_flatten(init)[0])
    pspec = packing.pack_spec({k: {kk: v[None] for kk, v in d.items()}
                               for k, d in init.items()})
    print(f"[train] CNN: {n_params:,} params, packed P_pad = "
          f"{pspec.padded:,}; X per round ({n}, {pspec.padded}) f32 = "
          f"{pspec.nbytes(n) / 1e6:.1f} MB")
    dev = torch.device("cuda")
    xs = torch.as_tensor(ds_test.x, device=dev)
    ys = torch.as_tensor(ds_test.y, device=dev).long()
    counters = {"aggregate": fused.aggregate_cuda,
                "mix_aggregate": fused.mix_aggregate_cuda,
                "mix": mixing.mix_cuda,
                "sparse_mix": sparse.sparse_mix_cuda,
                "sparse_mix_aggregate": sparse.sparse_mix_aggregate_cuda}

    def run(backend, record_mixed, scan, evaluate=True):
        stamps = [time.perf_counter()]
        exits = [stamps[0]]

        def eval_fn(p):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            out = {"test_acc": cnn.accuracy(cnn.cnn_apply, p, xs, ys),
                   "test_loss": float(loss_fn(p, (xs, ys)))}
            torch.cuda.synchronize()
            exits.append(time.perf_counter())
            return out

        server = FederatedServer(
            spec.build(), loss_fn, init,
            batcher, ServerConfig(T=T, t_max=rounds, seed=seed),
            execution=ExecutionConfig(backend=backend, scan=scan,
                                      record_mixed=record_mixed))
        for f in counters.values():
            f.launches = 0
        hist = server.run(eval_fn=eval_fn if evaluate else None)
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in counters.items()}
        if not evaluate:
            per_round = None
        elif scan:   # evals all run after the scanned trajectory
            per_round = [(stamps[1] - exits[0]) * 1e3 / rounds] * rounds
        else:
            per_round = [(stamps[t + 1] - exits[t]) * 1e3
                         for t in range(rounds)]
        return server, hist, counts, per_round

    ref_server, ref_hist, ref_counts, ref_ms = run("einsum", False, False)
    policy = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
              "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
              "cudnn.deterministic": torch.backends.cudnn.deterministic,
              "cudnn.benchmark": torch.backends.cudnn.benchmark}
    print(f"[train] precision policy as the port's engine set it: {policy}")
    if policy != {"cuda.matmul.allow_tf32": False, "cudnn.allow_tf32": False,
                  "cudnn.deterministic": True, "cudnn.benchmark": False}:
        raise AssertionError("the engine did not set its fp32 policy")
    if any(ref_counts.values()):
        raise AssertionError(f"einsum launched kernels: {ref_counts}")
    ref_leaves = tree_flatten(ref_server.params)[0]
    print(f"[train] einsum (plain PyTorch oracle), sequential: round ms "
          f"{[round(x, 1) for x in ref_ms]}, test_acc "
          f"{[r.metrics['test_acc'] for r in ref_hist.records]}")

    def bookkeeping(h):
        return ([(r.t, r.m, r.m_actual, r.d2s, r.d2d, r.psi_bound, r.eta)
                 for r in h.records], h.ledger.total_cost)

    # launches a run must make: one a round per dtype group on the packed
    # paths, one a round per leaf on the leaf-wise 'pallas' path
    groups = pspec.n_groups
    n_leaves = len(tree_flatten(init)[0])
    paths = [("fused", False, "aggregate", "aggregate", groups),
             ("fused", True, "fused", "mix_aggregate", groups),
             ("pallas", True, "pallas", "mix", n_leaves),
             ("sparse", False, "sparse_aggregate", "aggregate", groups),
             ("sparse", True, "sparse", "sparse_mix_aggregate", groups)]
    launches = {}
    for backend, record_mixed, effective, kernel, per_round in paths:
        finals = {}
        for scan in (False, True):
            server, hist, counts, ms = run(backend, record_mixed, scan)
            if server.effective_backend != effective:
                raise AssertionError(
                    f"{backend} record_mixed={record_mixed} dispatched "
                    f"{server.effective_backend}, expected {effective}")
            if counts[kernel] != per_round * rounds:
                raise AssertionError(f"{kernel} kernel launched "
                                     f"{counts[kernel]} times on its path, "
                                     f"not {per_round} a round: {counts}")
            others = {k: v for k, v in counts.items() if k != kernel}
            if any(others.values()):
                raise AssertionError(f"path {effective} launched other "
                                     f"kernels: {counts}")
            launches[kernel] = launches.get(kernel, 0) + counts[kernel]
            if bookkeeping(hist) != bookkeeping(ref_hist):
                raise AssertionError(f"{effective} History bookkeeping "
                                     "differs from einsum")
            leaves = tree_flatten(server.params)[0]
            worst = 0.0
            for a, b in zip(leaves, ref_leaves):
                if a.shape != b.shape or not torch.isfinite(a).all():
                    raise AssertionError(f"{effective}: bad params")
                if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                    raise AssertionError(
                        f"{effective} scan={scan}: params differ from "
                        f"einsum by {float((a - b).abs().max()):.3e}")
                worst = max(worst, float((a - b).abs().max()))
            finals[scan] = leaves
            accs = [r.metrics["test_acc"] for r in hist.records]
            print(f"[train] {backend} record_mixed={record_mixed} -> "
                  f"{effective}, {'scanned' if scan else 'sequential'}: "
                  f"{counts[kernel]} {kernel} launches, round ms "
                  f"{[round(x, 1) for x in ms]}, max|params - einsum| "
                  f"{worst:.3e}, test_acc {accs}")
        same = all(torch.equal(a, b) for a, b in zip(finals[False],
                                                     finals[True]))
        print(f"[train] {effective}: scanned == sequential bitwise: {same}")
    print(f"[train] History bookkeeping equal across all backends; total "
          f"comm cost {ref_hist.ledger.total_cost:.1f} (D2S "
          f"{ref_hist.ledger.total_d2s}, D2D {ref_hist.ledger.total_d2d})")
    launches["sparse_mix"] = mix_alone(loss_fn, init, batcher, spec, rounds,
                                       seed, counters)
    profile_rounds(lambda: run("fused", False, False, evaluate=False),
                   rounds)
    return launches


def mix_alone(loss_fn, init, batcher, spec, rounds, seed, counters):
    """Eq. 3 alone at full width, as a caller of the public op computes
    it: the first round's client deltas (the server's first batch, the
    plan's first step size) mixed by ``ops.sparse_mix`` with the ELL of
    the sparse plan's first round, against the dense oracle
    ``rounds.mix_deltas``.  Returns the sparse_mix launches."""
    import numpy as np
    import torch
    from repro_torch.core import rounds as rounds_lib
    from repro_torch.core.pytree import tree_map
    from repro_torch.core.server import ServerConfig
    from repro_torch.fl import packing
    from repro_torch.fl.plan import RoundPlan
    from repro_torch.kernels.mixing import ops

    dev = torch.device("cuda")
    plan = RoundPlan.connectivity_aware(
        spec.build(), ServerConfig(T=batcher.T, t_max=rounds, seed=seed),
        sparse=True)
    idx, w = (torch.as_tensor(a[0], device=dev) for a in plan.A_t.ell())
    x, y = batcher(np.random.default_rng([seed, 1]), 0)
    params = tree_map(lambda v: v.to(dev), init)
    eta = torch.tensor(plan.eta_t[0], dtype=torch.float32, device=dev)
    deltas = rounds_lib.client_deltas(loss_fn, params,
                                      (x.to(dev), y.to(dev)), eta)
    pspec = packing.pack_spec(deltas)
    bufs = packing.pack(deltas, pspec)
    torch.cuda.synchronize()
    for f in counters.values():
        f.launches = 0
    mixed = [ops.sparse_mix(idx, w, b) for b in bufs]
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in counters.items()}
    if counts["sparse_mix"] != pspec.n_groups or \
            sum(counts.values()) != counts["sparse_mix"]:
        raise AssertionError(f"eq. 3 alone launched {counts}")
    A0 = torch.as_tensor(plan.A_t[0].dense(), device=dev)
    want = packing.pack(rounds_lib.mix_deltas(A0, deltas), pspec)
    worst = 0.0
    for got, ref_buf in zip(mixed, want):
        if not torch.allclose(got, ref_buf, rtol=1e-5, atol=1e-7):
            raise AssertionError("ops.sparse_mix differs from the dense "
                                 "oracle")
        worst = max(worst, float((got - ref_buf).abs().max()))
    print(f"[train] eq. 3 alone: ops.sparse_mix on round 0's deltas "
          f"({idx.shape[0]} x {pspec.padded}, d_max {idx.shape[1]}): "
          f"{counts['sparse_mix']} sparse_mix launch(es), max|mixed - "
          f"dense oracle| {worst:.3e}")
    return counts["sparse_mix"]


def profile_rounds(fn, rounds: int, top: int = 12):
    """Trace ``fn()`` (a sequential aggregate-path run) with
    ``torch.profiler``, device activity only, and print the device events
    (kernels, copies, sets) by total time and the device's busy share of
    the traced wall time.  Events are read from the exported trace and
    kept once per correlation id (one per launch); the busy time is the
    union of their intervals, so events overlapping on several streams
    count once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()                                     # warm: cuDNN / vmap set-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    trace = ROOT / "build" / "profile_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    raw = [e for e in json.loads(trace.read_text())["traceEvents"]
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
           and e.get("ph") == "X"]
    events = {}
    for e in raw:
        corr = e.get("args", {}).get("correlation")
        key = (corr, e["name"]) if corr is not None else \
            (e["name"], e["ts"], e["dur"])
        events.setdefault(key, e)
    events = list(events.values())
    busy_us, end = 0.0, float("-inf")
    for e in sorted(events, key=lambda ev: ev["ts"]):
        busy_us += max(0.0, e["ts"] + e["dur"] - max(e["ts"], end))
        end = max(end, e["ts"] + e["dur"])
    per_name, per_stream = {}, {}
    for e in events:
        count, us = per_name.get(e["name"], (0, 0.0))
        per_name[e["name"]] = (count + 1, us + e["dur"])
        sid = e.get("args", {}).get("stream", e.get("tid"))
        count, us = per_stream.get(sid, (0, 0.0))
        per_stream[sid] = (count + 1, us + e["dur"])
    total = sum(us for _, us in per_name.values()) / 1e3
    busy = busy_us / 1e3
    print(f"[profile] aggregate path, {rounds} sequential rounds (no "
          f"eval), device activity traced: wall {wall_ms:.1f} ms, device "
          f"busy {busy:.1f} ms ({busy / wall_ms:.1%}, idle "
          f"{1 - busy / wall_ms:.1%}); {len(raw)} device events in the "
          f"trace, {len(events)} after one per correlation id, summing to "
          f"{total:.1f} ms")
    for sid, (count, us) in sorted(per_stream.items(), key=str):
        print(f"[profile]   stream {sid}: {count} events, {us / 1e3:.1f} ms")
    for name, (count, us) in sorted(per_name.items(),
                                    key=lambda kv: -kv[1][1])[:top]:
        print(f"[profile]   {us / 1e3:9.3f} ms {us / 1e3 / total:6.1%}  "
              f"x{count:<5d} {name[:90]}")


# -- phase 4 ----------------------------------------------------------------

def phase_scale(seed: int):
    """One round of the logreg model at n = 100,000 on both sparse
    backends, from a plan built sparse (nothing (n, n) anywhere)."""
    import torch
    from functools import partial as _partial
    from repro_torch import topology
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.core.server import ServerConfig
    from repro_torch.fl.engine import ExecutionConfig, make_engine
    from repro_torch.fl.plan import RoundPlan
    from repro_torch.kernels.mixing import fused, sparse
    from repro_torch.models import cnn

    n, c, B = 100_000, 12_500, 8
    t0 = time.perf_counter()
    plan = RoundPlan.connectivity_aware(
        topology.make_spec("ring", n=n, c=c, hops=1).build(),
        ServerConfig(T=1, t_max=1, m0=n // 10, seed=seed,
                     bound_kind="general"), sparse=True)
    plan_s = time.perf_counter() - t0
    if not plan.is_sparse or plan.A_t.max_degree != 2 or \
            int(plan.d2d_t[0]) != n:
        raise AssertionError("the n = 100,000 ring plan is not as built")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    batch = (torch.rand(n, 1, B, 28, 28, 1, generator=g, device=dev),
             torch.randint(0, 10, (n, 1, B), generator=g, device=dev))
    init = cnn.init_logreg(seed)
    n_params = sum(int(x.numel()) for x in tree_flatten(init)[0])
    loss_fn = _partial(cnn.l2_regularized_loss, cnn.logreg_apply)
    print(f"[scale] ring n={n} in {c} clusters of {n // c}: sparse plan "
          f"built in {plan_s:.2f} s (nnz {plan.A_t.nnz}, d_max "
          f"{plan.A_t.max_degree}, m {int(plan.m_t[0])}); logreg "
          f"{n_params:,} params, T=1, batch {B}")
    finals = {}
    for record_mixed, counter in ((False, fused.aggregate_cuda),
                                  (True, sparse.sparse_mix_aggregate_cuda)):
        eng = make_engine(ExecutionConfig(backend="sparse",
                                          record_mixed=record_mixed),
                          loss_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counter.launches = 0
        t0 = time.perf_counter()
        final, hist = eng.execute(plan, init, [batch])
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        if hist.records[0].d2d != n or counter.launches != 1:
            raise AssertionError(f"{eng.backend}: d2d "
                                 f"{hist.records[0].d2d}, "
                                 f"{counter.launches} launches")
        if peak >= n * n * 4:
            raise AssertionError(f"peak {peak / 1e9:.1f} GB: an (n, n) "
                                 "array was allocated")
        leaves = tree_flatten(final)[0]
        if not all(torch.isfinite(x).all() for x in leaves):
            raise AssertionError(f"{eng.backend}: non-finite params")
        finals[record_mixed] = leaves
        print(f"[scale] {eng.backend}: one round {round_ms:.1f} ms (first "
              f"call, host clock), peak device memory {peak / 1e9:.2f} GB, "
              f"d2d {hist.records[0].d2d}, {counter.launches} "
              f"{counter.__name__} launch")
    worst = max(float((a - b).abs().max())
                for a, b in zip(finals[False], finals[True]))
    if not all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
               for a, b in zip(finals[False], finals[True])):
        raise AssertionError(f"the sparse backends disagree by {worst:.3e}")
    print(f"[scale] sparse_aggregate and sparse agree: max|diff| "
          f"{worst:.3e}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        return _fail(f"no src/repro_torch beside {Path(__file__).name}: run "
                     "it from a checkout of the repository")
    import torch
    if not torch.cuda.is_available():
        return _fail("torch.cuda.is_available() is False: this smoke test "
                     "needs a CUDA card")
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (the checkout's package)

    name = torch.cuda.get_device_name(0)
    print(f"[env] {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, python {sys.version.split()[0]}")
    phase_build()
    rows = phase_kernels(70, 1_663_488)
    rows += phase_sparse_kernels(SEED)
    launches = phase_train(ROUNDS, SEED)
    phase_scale(SEED)
    for row in rows:
        row["launches"] = launches[row["name"]]
        if row["launches"] <= 0:
            raise AssertionError(f"{row['name']} never launched")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"kernels": rows}))
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
