#!/usr/bin/env python3
"""On-chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py            # one CUDA card

Phases (each raises on failure; nothing is caught):

1. build   -- compile every ``src/repro_torch/kernels/csrc/*.cu`` with
              ``nvcc`` (one process per source, in parallel) and print
              each kernel's register / shared-memory use from ptxas, and
              the conversion instructions in the SASS of the quantized
              kernels on the paper's path (``cuobjdump``).
2. kernels -- hold each dense hand-written kernel (aggregate,
              mix_aggregate, mix) against its plain PyTorch version on the
              card: at the
              main path's shapes (70 clients x 1,663,488 packed fp32
              columns for aggregate and mix_aggregate; 70 x each CNN
              leaf's size for mix, which the 'pallas' path launches once
              per leaf) and at ragged bf16 / fp32 shapes, among them the
              staged route's n limit (128) and one past it.  Print the
              error against its tolerance and, for mix_aggregate and
              mix, the route each call took ('staged': the TMA slab
              ring; 'generic': the first design), the kernel's time (for
              mix: the eight per-leaf launches of one round together)
              with its routes, the plain version's time, its bound
              (bytes or fp32 operations at the H100's published peaks)
              and the time of ``torch.matmul`` computing the same
              function.
   sparse  -- the same for the ELL kernels (sparse_mix,
              sparse_mix_aggregate) at six shapes: the ELL of a
              ``k_regular`` plan of the paper's configuration (70 x
              1,663,488 f32, d_max <= 10), an n = 100,000 ``ring`` (12,500
              clusters of 8, d_max = 2, p = 2,048 f32), a ragged ``hub``
              (37 x 1,000, f32 and bf16, d_max = 37), FedAvg's identity
              (d_max = 1), and ``k_regular`` plans at the staged route's
              n limit (128, f32 and bf16) and one past it (129).  The
              mixed outputs must equal their plain versions' bitwise on
              both routes, agg within 1e-5; each case prints its route.
              Times, with the route, beside ``torch.sparse.mm`` (CSR x
              dense) as the library yardstick.
   quant   -- the same for the dequant kernels (aggregate_dequant,
              mix_aggregate_dequant, sparse_mix_aggregate_dequant) on
              payloads the port's quantizer makes on the card (block 512),
              whose stored containers and scales must equal the CPU
              quantizer's bitwise: int8, int4 and fp8 at the paper's shape
              (the sparse kernel on the k_regular plan's ELL), ragged
              shapes (13 rows dense, a 37-row hub ELL), and the sparse
              kernel at n = 100,000 x 2,048 int8 ring.  The sparse mixed
              output must be bitwise its plain version's.  The dense and
              ELL mixes print their routes and must take the rule's
              (staged for n <= 128 and d_max <= 64: all but the ring);
              on the staged route both outputs of each must equal the
              fp32 staged kernel's on ``dequantize_group``'s payload,
              bitwise.  No single PyTorch call computes these functions;
              the dequantize + torch.matmul / torch.sparse.mm pair is
              printed as a two-call yardstick.
   gemv    -- the two GEMVs (aggregate in fp32 and bf16,
              aggregate_dequant on int8 / int4 / fp8, block 512) at both
              shapes the main paths give them: the paper's (70 x
              1,663,488; there also int8 at block 128, the paper
              experiment's, its quantizer held to the CPU's bitwise) and
              the scale round's (100,000 x 7,936 fp32 /
              bf16, 100,000 x 8,192 quantized), each against its plain
              version (rtol / atol 1e-5) and a second call bitwise equal
              to the first, with its row groups G, its time, its bound and
              torch.matmul's time (dequantize_group + torch.matmul for the
              quantized payloads); where G > 1, the device time of the
              GEMV kernel and of its second pass (torch.profiler).  The
              [kernels] / [quant] lines of the paper's shape print G too.
   flash   -- the flash-attention kernel against its plain version
              (``flash_attention_ref``): bf16, the tensor-core route, at
              qwen2-7b's prefill shape (B 2, S 2048, 28 / 4 heads of 128,
              causal) in the model's strided layout and contiguous, head
              dims 32 / 64 / 128, S of 1 and 17 (under one tile) and
              ragged, GQA groups 1 / 3 / 7 / 8, sliding windows 1 / 16 /
              100 / 256, non-causal, masked kv tails (900 and 0 of 1024
              keys) and Sq != Sk; fp32, the CUDA-core route, at head dims
              32 / 64 / 128 with GQA groups 1 to 8; head dims the kernels
              run zero-padded to the next instantiated one (zamba2's 80 at
              its shared block's shape, 48) on both routes (the
              reference's tolerances: 2e-5 fp32, 2e-2 bf16), each case
              with the route the library reports; its time at qwen2-7b's
              shape beside the plain version's, its bound (at the bf16
              tensor-core peak) and ``scaled_dot_product_attention``'s as
              the yardstick, and at zamba2's head dim 80 beside the
              library's.
   flash_bwd -- the flash backward kernels against their plain version
              (``flash_attention_bwd_ref``) on the forward's o and lse:
              at the stablelm-2-1.6b training cell's shape (B 4, 32
              heads of 64, S 4,096, causal), at head dim 128 with GQA
              and at zamba2's 80; within one bf16 ulp of the largest
              value, a second call bitwise equal; the time at the cell's
              shape beside the plain version's, its bound and the
              library's backward.  The training phases below count both
              kernels' launches: a forward per GQA attention call and
              one more for its recomputation, a backward per call
              (``flash_launches``).
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
              the port's engine sets (no TF32, deterministic cuDNN);
              scanned must equal sequential bitwise.  Then eq. 3 alone
              (``ops.sparse_mix``, -> sparse_mix) on the first round's
              client deltas with the plan's ELL, against the dense
              oracle.  Every kernel's launch count (and route count) is
              reset before its path and read after it: every
              mix_aggregate, sparse_mix_aggregate and sparse_mix launch
              there must take the staged route, and so must every mix
              launch but the 10-value leaf's.  Last, one more sequential 'fused' run
              without evaluation is traced with ``torch.profiler``
              (device activity only): the device events by time, one per
              correlation id, and the device's busy share of the traced
              wall time.
              Then the quantized payload path (error feedback, block 512):
              int8 on 'fused' (-> aggregate_dequant), 'fused' with
              record_mixed (-> mix_aggregate_dequant), 'sparse' (->
              aggregate_dequant after the ELL combine row) and 'sparse'
              with record_mixed (-> sparse_mix_aggregate_dequant), and
              int4 and fp8 on 'fused', each scanned and sequential,
              against the quantized 'einsum' oracle of its storage
              (bookkeeping exactly equal; params within rtol 1e-4 / atol
              1e-5 or, where a rounding decision flipped, within one grid
              step times the combine weight, summed over the rounds;
              scanned == sequential bitwise; every mix_aggregate_dequant
              and sparse_mix_aggregate_dequant launch on the staged
              route), with the time of the plain-PyTorch quantizer in a
              round; and one traced int8 run.
   control -- the closed loop at the same width, through
              ``FederatedServer.run(controller=)``: ``static`` on 'fused'
              (-> aggregate; bitwise the run of the precomputed
              ``connectivity_aware`` plan), ``threshold:tau=2`` on 'fused'
              with record_mixed (-> mix_aggregate),
              ``threshold:scheme=sampled`` and ``threshold:tau=2`` on
              'sparse' with record_mixed (-> sparse_mix_aggregate; a live
              round's ELL is as wide as its own widest row, the replay's
              as the plan's), and ``similarity`` over a ``learned:k=3``
              topology on 'fused'.  Each run's launches are counted with
              the counts reset before it, and its routes asserted (all
              staged); its realized plan replayed through ``run(plan=)``
              must reproduce it bitwise, with the same launches and
              routes; 'einsum' under the same controller (for the sparse
              runs: replaying the realized plan) within rtol 1e-4 / atol
              1e-5; the sparse runs also hold round 0's payload through
              sparse_mix_aggregate with 6 more ELL padding slots, bitwise.
              Round times (host clock) and the ``similarity`` feed's ms:
              the device-to-host copy of a round's deltas, the
              controller's whole ``feed`` (host numpy), and within it the
              float64 cast with normalisation and the Gram, timed apart.
   hetero  -- ``optim.HeteroClientOptimizers`` with the CNN at n = 70: an
              all-'sgd' runner against ``client_deltas`` (rtol 1e-6, atol
              1e-7); two 'sgd,adam' instances, two ``deltas`` calls each
              on the same inputs, bitwise equal to each other (the 'sgd'
              clients repeat, the 'adam' ones move on); ms a call.
   quickstart -- ``examples/quickstart_torch.py`` once on the card, its
              table printed, its columns the plan's.
   paper   -- ``examples/fl_paper_experiment_torch.py`` (the paper's Sec. 6
              experiment) on the card at its defaults, the CNN at full
              width, n = 70, c = 7, T = 5, batch 16, 15 rounds, both D2S
              cases: its five runs (semidec, semidec-exact, semidec-int8
              on 'aggregate' with int8 at block 128 -> aggregate_dequant,
              fedavg, colrel), rows, summary and savings printed with each
              run's wall s, ms a round after the first and whether its
              params stayed finite; every row's cost, m and byte columns
              exactly those of the host's ``RoundPlan`` and the packed
              layout's arithmetic, accuracies finite in [0, 1], one
              aggregate_dequant launch a round on semidec-int8 and no
              other launch; semidec-int8 after every round against its
              quantized 'einsum' oracle (built with the twin's
              ``experiment``) by [train]'s quant rule, non-finite values
              where the oracle's are.
   stream  -- the semi-async runtime at the same width, 4 rounds, through
              ``FederatedServer(execution=ExecutionConfig(stream=...))``:
              a pristine ``StreamConfig()`` on 'fused' bitwise the
              ``LocalEngine`` run with the same aggregate launches; under
              ``STREAM_FAULTS`` (markov p_fail 0.2, exponential latency of
              mean 0.5) with ``STREAM_POLICY`` (buffer 40, deadline 2.0,
              poly staleness) 'fused' must take the stale path (aggregate
              once per contributing cohort), keep History bitwise the
              'einsum' run's and params within rtol 1e-4 / atol 1e-5, and
              its realized plan, replayed fault-free, must reproduce it
              bitwise with the same launches; the same with
              ``client_optim='sgd,adam'``; ``threshold:tau=2`` closed-loop
              (``StreamEngine.execute_controlled``) under the same faults,
              replayed bitwise.  Round ms after round 0 and launches.
   ingest  -- the wall-clock runtime: ``IngestEngine`` (clock 'wall',
              0.2 s a virtual unit, 4 workers) under the same faults on
              'fused', with and without overlapping dispatch, traced
              (device activity only): ``Recording.verify() == []`` on the
              card, every overlapped cohort's payload event complete when
              its future resolved; wall seconds, rounds closed, late /
              lost / duplicate uploads, launches, the device's busy share.
              Then ``python -m repro_torch.launch.stream --selfcheck`` and
              ``launch.ingest --selfcheck`` on cuda ('fused').
4. scale   -- an n = 100,000 ``ring`` plan built sparse (12,500
              clusters of 8), one round of the logreg model (7,850
              params, T = 1, batch 8 drawn from the seed) on 'sparse',
              on 'sparse' with record_mixed, and on 'sparse' with an int8
              payload (block 512; -> aggregate_dequant at its scale
              shape): d2d == n, the two fp32 rounds agree, the int8 one
              is within one grid step of them (as in [train]), the ELL
              kernel takes the generic route, each GEMV prints its G, and
              the peak device memory stays far below one (n, n) f32 array
              (40 GB).
5. lm      -- the port's ``Model`` (``repro_torch.models``): qwen2-7b at
              full width and depth in bf16 from random weights, a forward
              on 2 x 2048 tokens with attn_impl='flash' (-> 28 flash
              launches, counted, all on the tensor-core route) and with
              'ref', ``generate`` (prefill, then 16 greedy decode steps),
              both traced with ``torch.profiler``; then qwen2-7b's widths
              in fp32 at 4 layers: flash vs ref logits within 1e-4,
              prefill + decode vs the forward within 2e-3.
   zoo     -- the zoo's other families (``ZOO``), each in bf16 at full
              width from random weights and freed before the next:
              phi3.5-moe-42b-a6.6b at 25 of 32 layers, deepseek-v2-236b
              at its dense layer + 7 MoE layers (MLA), mamba2-1.3b and
              zamba2-2.7b whole; a 2 x 2048 forward with the launch counts
              reset before it and read after it (flash: one a phi3.5
              layer, 9 for zamba2's shared block at head dim 80, none for
              MLA or mamba2, all on the tensor-core route; the MoE's
              grouped GEMMs all on ``grouped_mm``), the 'ref' forward
              where the counted one took flash, ``generate`` (prefill +
              16 decode steps), peak GB, and the two grouped-GEMM routes
              timed at each MoE's shapes; then fp32 gates at full width
              and 4 / 2 / 6 / 6 layers: flash vs ref within 1e-4,
              prefill + decode vs the forward within 2e-3, ragged vs dense
              MoE within 2e-4, chunked vs full MLA within 2e-3.
   serve   -- the serving CLI's own per-rank function
              (``launch/serve.py::serve_rank``, what ``--devices 1`` runs:
              a world-size-1 NCCL group in this process, the mesh steps)
              for reduced qwen2-7b, phi3.5-moe and mamba2 (vocab 512,
              fp32, batch 4, 32 prompt tokens, 16 new): the CLI's lines,
              and its tokens and logits against the one-device
              ``Model.prefill`` / ``decode`` on the weights it drew (the
              greedy tokens equal, logits within 2e-4).
   lmtrain -- federated LM training (``LMT_*``): stablelm-1.6b at its
              published widths and LMT_LAYERS of its 24 layers in bf16
              from random
              weights, trained through ``FederatedServer(execution=
              ExecutionConfig(model_cfg=...))`` with per-layer remat,
              chunked attention and a chunked loss: n = 4 clients in c =
              2 clusters, T = 5, one 4,096-token sequence a client a
              step from ``make_token_stream`` / ``lm_batches``, 2 rounds
              each on 'einsum', 'fused' (-> aggregate) and 'fused' with
              record_mixed (-> mix_aggregate, staged), launches counted
              from 0 a run (every run's attention: ``flash_launches``);
              the kernel backends' change from the init
              params against einsum's after round 0 and after the last
              (CHANGE_REL), einsum moving
              at least MOVED_MIN of the values; round ms, tokens/s, peak
              GB.  One 'aggregate' round timed in its two calls (local
              SGD's share of it); both kernels on that round's payload
              ((4, ~1.645e9) bf16) against their plain versions in
              column chunks (agg within AGG_REL of sum |w_i X_i|, mixed
              within MIXED_ULPS bf16 ulp of each value), timed beside
              them, their byte bounds and ``torch.matmul``; one traced
              round; fp32 pins at full
              width and 2 layers (1,024 tokens): the kernel backends
              within rtol 2e-4 / atol 2e-5 of einsum, scanned ==
              sequential, all-ones active == None, remat on == off, all
              bitwise.
   moetrain - [lmtrain]'s recipe on phi3.5-moe (``MOET_*``) at its
              published widths and MOET_LAYERS of its 32 layers, MOET_S
              tokens a client a step (the MoE's dense oracle under vmap;
              its fp32 router makes a second dtype group, so each kernel
              launches twice a round); ``expert_matmul.routes``
              unchanged; fp32 pins at MOET_PIN_N clients of MOET_PIN_S
              tokens, scanned == sequential bitwise (no trace, no
              all-ones or remat pins).
   mesh    -- the mesh runtime (``fl/distributed.py``) on a world-size-1
              NCCL group in this process, mesh (1, 1, 1), the same model
              at MESH_LAYERS layers (1,024 tokens a step): each of the
              five schedules 2 rounds sequential and scanned (bitwise),
              against LocalEngine's
              round function at n = 1 (the change from init within
              CHANGE_REL[0]); 'fused' launches
              aggregate once a round, every schedule the flash kernels
              as ``flash_launches`` says.
   tp      -- tensor parallelism inside a client (``models/sharding.py``):
              two ranks spawned on the card (gloo, which takes CUDA
              tensors for all_reduce / broadcast; NCCL refuses two ranks
              on one device), mesh (1, 1, 2).  (a) The model of [mesh]
              at all 24 layers and [mesh]'s inputs on 'fused' and
              'ring', a rank's launches
              counted from 0 ('fused': aggregate once a round on its
              shard; the flash kernels on its heads, ``flash_launches``),
              scanned == sequential bitwise, the gathered
              params' change from init after every round within
              TP_CHANGE_REL of LocalEngine's round function's; fp32 pins
              at 2 layers against the one-rank round (rtol 2e-4 / atol
              2e-5); (f) the same on 'ring' with sequence parallelism and
              the SP-MLP, every sequence collective on gloo's broadcast
              route.  (b) qwen2-7b bf16 at full size served through the
              mesh prefill / decode steps (2 x 2,048 prompt, 16 decode
              steps; 14 q / 2 kv heads a rank, every flash launch on the
              tensor-core route, and the kernel held against its plain
              version on each rank's own layer-0 q / k / v), max|dlogits| and
              top-1 agreement against the one-device path, then fp32 at
              4 layers within 2e-4 of it; (c) mamba2-1.3b and zamba2-2.7b
              whole (32 / 40 SSD heads a rank; zamba2's shared block at
              16 / 16 heads, head dim 80, through flash) and (d)
              deepseek-v2 at 1 + TP_DSV2_MOE layers (MLA 64 heads a rank,
              tensor-parallel experts) the same way, top-1 at least
              TP_TOP1_MIN for (c)'s archs (no router; beside it both
              bf16 runs' top-1 against a one-device fp32 run of the same
              weights; read after every case's fp32 gate has run), fp32
              gates on TP_GATE_S tokens; (e) phi3.5-moe at TP_EP_LAYERS layers
              with moe_sharding='expert' (8 whole experts a rank):
              forward and gradient against the one-device ragged path,
              the slots the capacity dropped, an fp32 gate at 8 tokens
              (nothing can drop).  GB a rank, ms a round, prefill ms,
              decode ms a step.  ``phase_tp`` takes the mesh shapes and
              the backend (four cards: NCCL at (1, 2, 2) with zero on
              'ring', the serving and (e) at (1, 1, 4)).  Each rank
              tallies its warm-up prefill (``roofline.OpCost``) for
              [dryrun].
   ckpt    -- checkpoints (``repro_torch.ckpt``; after [lmtrain], whose
              trained params it takes): the paper cell's CKPT_ROUNDS
              rounds against CKPT_AT rounds, ``save_checkpoint`` of the
              card's params, ``load_checkpoint`` into a like tree on the
              card and ``plan[CKPT_AT:]``, on 'fused' (-> aggregate) and
              'sparse' with record_mixed (-> sparse_mix_aggregate, staged),
              sequential and scanned: params bitwise, History equal;
              [lmtrain]'s trained bf16 tree (1.44 GB) round-tripped
              bitwise, write / read s and GB/s; the reference-written
              ``tests/data/ckpt_ref`` file loaded on the card bitwise.
   dryrun  -- the dry-run (``launch/dryrun.py``, ``roofline``):
              DRYRUN_COMBOS (production world of 256 fake ranks, meta
              stand-ins) run in a background process on the host from the
              build on, each record's line printed here, all OK; one MoE
              combo on FakeTensorMode CUDA stand-ins (the card's
              ``grouped_mm`` branch) counting the meta run's FLOPs and
              collectives; qwen2-7b's [lm] 'ref' forward counted on fake
              CUDA tensors equal to ``FlopCounterMode`` around the real
              forward, exactly, with MemTracker's peak beside
              ``max_memory_allocated`` and the measured ms beside
              ``roofline_report``'s terms; [tp] (b)'s prefill collectives
              (rank 0's tally) equal to the dry-run's of the same step.
6. report  -- a ``{"kernels": [...]}`` JSON line (nine kernels; the
              six routed ones with the ``routes`` of their main-path
              launches; the launches are those of [train], [control],
              the quickstart, [paper], [stream], [ingest], [lmtrain], [ckpt],
              [moetrain], [mesh] and [tp] (every rank's), flash's those
              of [lm], [zoo] and [tp]; aggregate's and mix_aggregate's
              rows also carry ``lm_payload`` and ``moe_payload``, their
              numbers at [lmtrain]'s and [moetrain]'s payloads), the
              card's name and power
              limit (nvidia-smi), and the final ``{"ok": true,
              "device": {...}}`` line.

The phases run in the order above, but for [ckpt], which follows
[lmtrain] (and [moetrain] follows it), and [dryrun], whose combos start
in the background after [build].  It imports only ``torch``, numpy and
``repro_torch`` (never JAX), and exits non-zero without a result when no CUDA card is present or when run
outside a checkout of the repository.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from contextlib import nullcontext
from functools import partial
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ROUNDS = 3          # rounds of Algorithm 1 per training run
SEED = 0            # data, partition, weights and plan

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bandwidth, the
# fp32 rate outside the tensor cores (the mixing kernels run full fp32)
# and the bf16 tensor-core rate (the least time of bf16 attention).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12


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


def routed(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` through a wrapper that counts its launches
    by route (``fn.routes``), and the route that one call's launch
    took."""
    before = dict(fn.routes)
    out = fn(*args, **kwargs)
    moved = [r for r in fn.routes if fn.routes[r] != before[r]]
    if len(moved) != 1:
        raise AssertionError(f"{fn.__name__}: routes {before} -> "
                             f"{fn.routes}")
    return out, moved[0]


def bound(nbytes: int, flops: int, flops_per_s: float = FP32_FLOPS_PER_S):
    """``(bound_ms, bound_by)``: the larger of moving ``nbytes`` at the
    HBM rate and doing ``flops`` operations at ``flops_per_s`` (default:
    fp32 on the CUDA cores)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / flops_per_s * 1e3
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
        if lib.name.startswith("libquant_mixing-"):
            sass_conversions(lib)


# the quantized kernels' instances on the paper's path (n = 70, d_max 9):
# generic dense RM 5, staged dense RM 9, both ELL D 16, and the
# aggregate_dequant GEMV (row_groups.cuh's gemv_kernel on QuantLoad<storage,
# words a thread>, its second argument the warps along the rows); a
# template's first argument is the storage (0 int8, 1 int4, 2 fp8)
SASS_KERNELS = re.compile(
    r"(mix_aggregate_dequant_kernelILi(\d)ELi5E|mix_dequant_staged_kernelILi"
    r"(\d)ELi9E|sparse_mix_dequant_kernelILi(\d)ELi16E|"
    r"sparse_dequant_staged_kernelILi(\d)ELi16E|"
    r"gemv_kernelI\w*?QuantLoadILi\dELi\dEEELi\dE)")
GEMV_ARGS = re.compile(r"QuantLoadILi(\d)ELi(\d)EEELi(\d)E")
SASS_OP = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def sass_conversions(lib) -> None:
    """Print the conversion instructions (I2F*, F2F*, F2FP*, HADD2.F32)
    of the quantized kernels in ``SASS_KERNELS``, counted in the SASS that
    ``cuobjdump`` reads from the built library: where each decodes, and on
    which pipe.  Static counts: the generic kernels' sit in the slot loop,
    the staged kernels' in the decode pass once a tile."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    name, ops, total = None, {}, 0

    def flush():
        if name is not None:
            print(f"[build]   sass {name}: {total} instructions, "
                  f"conversions {dict(sorted(ops.items())) or 'none'}")

    for line in sass.splitlines():
        if "Function : " in line:
            flush()
            m = SASS_KERNELS.search(line)
            name = m.group(1) if m else None
            if name and name.startswith("gemv"):
                name = "gemv_kernel<QuantLoad<{}, {}>, {}>".format(
                    *GEMV_ARGS.search(name).groups())
            ops, total = {}, 0
        elif name is not None:
            m = SASS_OP.search(line)
            if m:
                total += 1
                op = m.group(1)
                if op.startswith(("I2F", "F2F")) or op == "HADD2.F32":
                    ops[op] = ops.get(op, 0) + 1
    flush()


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

    def check(name, got, want, t, route=None):
        ok = torch.allclose(got.float(), want.float(), **t)
        e = err(got, want)
        print(f"[kernels]   {name}: max|err| {e:.3e} "
              f"(rtol {t['rtol']:.1e}, atol {t['atol']:.1e})"
              + (f", route {route}" if route else ""))
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return e

    # the staged route of mix_aggregate / mix takes n <= 128 (csrc/mixing.cu):
    # a case at the limit and one past it, both with a ragged last tile
    shapes = [(n, p, torch.float32), (37, 100_003, torch.bfloat16),
              (13, 1001, torch.float32), (9, 4096, torch.bfloat16),
              (128, 100_004, torch.float32), (129, 100_004, torch.float32),
              (128, 50_008, torch.bfloat16), (129, 50_008, torch.bfloat16)]
    errs = {"aggregate": 0.0, "mix_aggregate": 0.0, "mix": 0.0}
    for n_, p_, dtype in shapes:
        print(f"[kernels] shape n={n_} p={p_} {dtype}")
        A, w, X = inputs(n_, p_, dtype)
        e = check("aggregate", fused.aggregate_cuda(w, X),
                  ref.aggregate_ref(w, X), agg_tol)
        (mixed, agg), route = routed(fused.mix_aggregate_cuda, A, w, X)
        mixed_r, agg_r = ref.mix_aggregate_ref(A, w, X)
        e2 = max(check("mix_aggregate/mixed", mixed, mixed_r, tol[dtype],
                       route),
                 check("mix_aggregate/agg", agg, agg_r, agg_tol, route))
        mixed, route = routed(mixing.mix_cuda, A, X)
        check("mix", mixed, ref.mix_ref(A, X), tol[dtype], route)
        if (n_, p_) == (n, p):       # report the main path's shape
            errs.update(aggregate=e, mix_aggregate=e2)
    # the 'pallas' path launches mix once per CNN leaf: (n, leaf size)
    leaf_p = [int(x.numel()) for x in tree_flatten(cnn.init_cnn(SEED))[0]]
    A, w, X = inputs(n, p, torch.float32)
    leaves = [torch.randn(n, pl, generator=g, device=dev) for pl in leaf_p]
    print(f"[kernels] mix at the {len(leaf_p)} per-leaf shapes n={n} "
          f"p={leaf_p} {torch.float32}")
    for pl, x in zip(leaf_p, leaves):
        mixed, route = routed(mixing.mix_cuda, A, x)
        errs["mix"] = max(errs["mix"], check(
            f"mix (p={pl})", mixed, ref.mix_ref(A, x), tol[torch.float32],
            route))
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
    wrappers = {"aggregate": fused.aggregate_cuda,
                "mix_aggregate": fused.mix_aggregate_cuda,
                "mix": mixing.mix_cuda}
    for name, replaces, kern, plain, lib, nbytes, flops in specs:
        fn = wrappers[name]
        before = dict(getattr(fn, "routes", {}))
        ms = cuda_ms(kern)
        routes = {r: c - before[r] for r, c in getattr(fn, "routes",
                                                       {}).items()}
        plain_ms = cuda_ms(plain)
        lib_ms = cuda_ms(lib)
        b_ms, b_by = bound(nbytes, flops)
        shape = (f"{len(leaf_p)} leaves ({n}, p_leaf)" if name == "mix"
                 else f"({n}, {p})")
        print(f"[kernels] {name} @ {shape} f32"
              + (f", routes {routes}" if routes else "")
              + (f", G {fused.aggregate_row_groups(X)}"
                 if name == "aggregate" else "")
              + f": {ms:.4f} ms "
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
    print(f"[kernels] mix @ ({n}, {p}) f32, the same bytes in one launch, "
          f"route {routed(mixing.mix_cuda, A, X)[1]}: "
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

    def check(name, got, want, t, route):
        """``t`` None: bitwise (the mixed outputs, on both routes)."""
        e = float((got.float() - want.float()).abs().max())
        rule = ("bitwise" if t is None
                else f"rtol {t['rtol']:.1e}, atol {t['atol']:.1e}")
        print(f"[sparse]   {name}: max|err| {e:.3e} ({rule}), route {route}")
        ok = (torch.equal(got, want) if t is None
              else torch.allclose(got.float(), want.float(), **t))
        if not ok:
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
        # the staged route takes n <= 128 (csrc/sparse_mixing.cu): at the
        # limit and one past it, ragged last tiles
        ("limit: k_regular, 16 clusters of 8", "k_regular", 128, 16,
         100_004, torch.float32, "connectivity_aware",
         dict(k_range=(6, 7), p_fail=0.1)),
        ("limit: k_regular, 16 clusters of 8", "k_regular", 128, 16,
         50_008, torch.bfloat16, "connectivity_aware",
         dict(k_range=(6, 7), p_fail=0.1)),
        ("past the limit: k_regular, 3 clusters of 43", "k_regular", 129, 3,
         100_004, torch.float32, "connectivity_aware",
         dict(k_range=(6, 9), p_fail=0.1)),
        ("past the limit: k_regular, 3 clusters of 43", "k_regular", 129, 3,
         50_008, torch.bfloat16, "connectivity_aware",
         dict(k_range=(6, 9), p_fail=0.1)),
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
        got, route = routed(sparse.sparse_mix_cuda, idx, w, X)
        e1 = check("sparse_mix", got, ref.sparse_mix_ref(idx, w, X), None,
                   route)
        (mixed, agg), route = routed(sparse.sparse_mix_aggregate_cuda, idx,
                                     w, wrow, X)
        mixed_r, agg_r = ref.sparse_mix_aggregate_ref(idx, w, wrow, X)
        e2 = max(check("sparse_mix_aggregate/mixed", mixed, mixed_r, None,
                       route),
                 check("sparse_mix_aggregate/agg", agg, agg_r, agg_tol,
                       route))
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
            fn = getattr(sparse, f"{name}_cuda")
            before = dict(fn.routes)
            ms = cuda_ms(kern)
            route = "/".join(r for r in fn.routes
                             if fn.routes[r] != before[r])
            plain_ms = cuda_ms(plain, iters=5)
            lib_ms = cuda_ms(lib, iters=10)
            b_ms, b_by = bound(nbytes, flops)
            print(f"[sparse] {name} @ {which} ({n}, {p}) f32, route "
                  f"{route}: {ms:.4f} ms "
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


def phase_quant_kernels(seed: int):
    """The three dequant kernels against their plain versions on payloads
    the port's quantizer made on the card (block 512): at the paper's
    shape for int8, int4 and fp8 (the sparse kernel on the ELL of a
    ``k_regular`` plan of the paper's configuration), at ragged shapes (13
    rows dense, a 37-row ``hub`` ELL), and the sparse kernel at n = 100,000
    x 2,048 int8 ``ring``.  The CUDA quantizer must give the CPU's stored
    containers and scales bitwise.  mix_aggregate_dequant and
    sparse_mix_aggregate_dequant must take the route the rule gives
    (staged everywhere but the ring) and, on the staged route, equal the
    fp32 staged kernels on the dequantized payload bitwise.  Returns the
    report rows (int8 at the paper's shape; launch counts filled in by
    phase 3)."""
    import torch
    from repro_torch.fl import packing
    from repro_torch.kernels.mixing import fused, ops, ref, sparse

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    block, f4 = 512, 4
    # fp32 sums over <= n rows in another order than the plain version's
    tol = dict(rtol=1e-5, atol=1e-5)
    src = "src/repro_torch/kernels/csrc/quant_mixing.cu"

    def check(name, got, want, bitwise=False):
        e = float((got - want).abs().max())
        ok = torch.equal(got, want) if bitwise else \
            torch.allclose(got, want, **tol)
        print(f"[quant]   {name}: max|err| {e:.3e} ("
              + ("bitwise" if bitwise else
                 f"rtol {tol['rtol']:.1e}, atol {tol['atol']:.1e}") + ")")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        return e

    def csr_of(A, wrow, n):
        """[A; wrow] as a CSR tensor (the yardstick's operand)."""
        nnz = A.nnz
        return torch.sparse_csr_tensor(
            torch.as_tensor(list(A.indptr) + [nnz + n], device=dev),
            torch.cat([torch.as_tensor(A.indices, dtype=torch.int64,
                                       device=dev),
                       torch.arange(n, device=dev)]),
            torch.cat([torch.as_tensor(A.data, device=dev), wrow]),
            size=(n + 1, n), check_invariants=True)

    def case(label, Xf, storage, dense, ell, timed):
        """Quantize Xf, check the kernels on the route the rule gives
        (csrc/quant_mixing.cu: staged for n <= 128, the ELL also d_max
        <= 64), optionally time them."""
        quant = packing.QuantSpec(storage=storage, block=block)
        n, p = Xf.shape
        Xq, S = packing.quantize_group(Xf, quant)
        Xq_h, S_h = packing.quantize_group(Xf.cpu(), quant)
        as_bits = (lambda t: t.view(torch.uint8)) if storage == "fp8" \
            else (lambda t: t)
        if not (torch.equal(as_bits(Xq).cpu(), as_bits(Xq_h))
                and torch.equal(S.cpu(), S_h)):
            raise AssertionError(f"{label} {storage}: the CUDA quantizer "
                                 "differs from the CPU's")
        del Xq_h, S_h
        q = dict(storage=storage, block=block)
        print(f"[quant] {label}: n={n} p={p} {storage} (stored "
              f"{Xq.numel() * Xq.element_size() / 1e6:.1f} MB + scales "
              f"{S.numel() * 4 / 1e6:.2f} MB; CUDA quantizer == CPU "
              f"quantizer bitwise)")
        errs, routes = {}, {}

        def on_route(name, route, want_route, got, staged_twin):
            """The route must be the rule's; on the staged route both
            outputs must equal the fp32 staged kernel's on the payload
            dequantize_group gives, bitwise."""
            print(f"[quant]   {name}: route {route}")
            if route != want_route:
                raise AssertionError(f"{name} at n = {n} took the {route} "
                                     f"route, not {want_route}")
            routes[name] = route
            if route != "staged":
                return
            (twin, twin_route) = routed(
                *staged_twin(packing.dequantize_group(Xq, S, quant)))
            same = twin_route == "staged" and all(
                torch.equal(a, b) for a, b in zip(got, twin))
            print(f"[quant]   {name}: == the fp32 staged kernel on "
                  f"dequantize_group's payload, bitwise: {same}")
            if not same:
                raise AssertionError(f"{name} differs from the fp32 staged "
                                     "kernel on the dequantized payload")

        if dense is not None:
            A, w = dense
            errs["aggregate_dequant"] = check(
                "aggregate_dequant", fused.aggregate_dequant_cuda(
                    w, Xq, S, **q),
                ref.aggregate_dequant_ref(w, Xq, S, storage, block))
            got, route = routed(fused.mix_aggregate_dequant_cuda, A, w, Xq,
                                S, **q)
            want = ref.mix_aggregate_dequant_ref(A, w, Xq, S, storage,
                                                 block)
            errs["mix_aggregate_dequant"] = max(
                check("mix_aggregate_dequant/mixed", got[0], want[0]),
                check("mix_aggregate_dequant/agg", got[1], want[1]))
            del want
            on_route("mix_aggregate_dequant", route,
                     "staged" if n <= 128 else "generic", got,
                     lambda x: (fused.mix_aggregate_cuda, A, w, x))
            del got
        if ell is not None:
            Asp, idx, wl, wrow = ell
            got, route = routed(sparse.sparse_mix_aggregate_dequant_cuda,
                                idx, wl, wrow, Xq, S, **q)
            want = ref.sparse_mix_aggregate_dequant_ref(idx, wl, wrow, Xq, S,
                                                        storage, block)
            errs["sparse_mix_aggregate_dequant"] = max(
                check("sparse_mix_aggregate_dequant/mixed", got[0], want[0],
                      bitwise=True),
                check("sparse_mix_aggregate_dequant/agg", got[1], want[1]))
            del want
            on_route("sparse_mix_aggregate_dequant", route,
                     "staged" if n <= 128 and idx.shape[1] <= 64
                     else "generic", got,
                     lambda x: (sparse.sparse_mix_aggregate_cuda, idx, wl,
                                wrow, x))
            del got
        torch.cuda.synchronize()
        if not timed:
            return {}
        pay = Xq.numel() * Xq.element_size() + S.numel() * f4
        out = {}
        specs = []
        if dense is not None:
            B = torch.cat([A, w[None]])
            specs += [
                ("aggregate_dequant", "src/repro/kernels/mixing/fused.py:236",
                 lambda: fused.aggregate_dequant_cuda(w, Xq, S, **q),
                 lambda: ref.aggregate_dequant_ref(w, Xq, S, storage, block),
                 lambda: torch.matmul(w, packing.dequantize_group(
                     Xq, S, quant)),
                 "dequantize_group + torch.matmul",
                 pay + n * f4 + p * f4, n * p + 2 * n * p),
                ("mix_aggregate_dequant",
                 "src/repro/kernels/mixing/fused.py:199",
                 lambda: fused.mix_aggregate_dequant_cuda(A, w, Xq, S, **q),
                 lambda: ref.mix_aggregate_dequant_ref(A, w, Xq, S, storage,
                                                       block),
                 lambda: torch.matmul(B, packing.dequantize_group(
                     Xq, S, quant)),
                 "dequantize_group + torch.matmul",
                 pay + (n + 1) * n * f4 + n * p * f4 + p * f4,
                 n * p + 2 * (n + 1) * n * p)]
        if ell is not None:
            Asp, idx, wl, wrow = ell
            B_csr = csr_of(Asp, wrow, n)
            specs.append(
                ("sparse_mix_aggregate_dequant",
                 "src/repro/kernels/mixing/sparse.py:162",
                 lambda: sparse.sparse_mix_aggregate_dequant_cuda(
                     idx, wl, wrow, Xq, S, **q),
                 lambda: ref.sparse_mix_aggregate_dequant_ref(
                     idx, wl, wrow, Xq, S, storage, block),
                 lambda: torch.sparse.mm(B_csr, packing.dequantize_group(
                     Xq, S, quant)),
                 "dequantize_group + torch.sparse.mm",
                 pay + idx.numel() * 8 + n * f4 + n * p * f4 + p * f4,
                 n * p + 2 * Asp.nnz * p + 2 * n * p))
        for name, replaces, kern, plain, yard, yard_name, nbytes, flops \
                in specs:
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(plain, iters=5)
            yard_ms = cuda_ms(yard, iters=10)
            b_ms, b_by = bound(nbytes, flops)
            print(f"[quant] {name} @ {label} ({n}, {p}) {storage}"
                  + (f", route {routes[name]}" if name in routes else "")
                  + (f", G {fused.aggregate_dequant_row_groups(Xq, S, **q)}"
                     if name == "aggregate_dequant" else "")
                  + f": {ms:.4f} ms (plain {plain_ms:.4f} ms; yardstick, two "
                  f"calls, {yard_name} {yard_ms:.4f} ms; bound {b_ms:.4f} "
                  f"ms by {b_by}: {b_ms / ms:.1%} of it; "
                  f"{nbytes / ms / 1e6:.0f} GB/s)")
            out[name] = {"name": name, "route": "cuda", "source": src,
                         "replaces": replaces, "launches": 0,
                         "max_abs_err": errs[name], "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": None}
        return out

    def ell_of(family, n, c, ctor="connectivity_aware", **params):
        Asp, tau, m = _ell_case(family, n, c, seed, ctor, **params)
        idx_np, w_np = Asp.ell()
        idx = torch.as_tensor(idx_np, device=dev)
        wl = torch.as_tensor(w_np, device=dev)
        wrow = ops.combine_weights_ell(idx, wl, torch.as_tensor(
            tau, device=dev), torch.tensor(m, device=dev))
        return Asp, idx, wl, wrow

    def dense_of(n):
        A = torch.rand(n, n, generator=g, device=dev)
        A = A / A.sum(0, keepdim=True)             # column-stochastic
        return A, torch.rand(n, generator=g, device=dev) / n

    rows = {}
    n, p = 70, 1_663_488
    dense, ell = dense_of(n), ell_of("k_regular", n, 7, k_range=(6, 9),
                                     p_fail=0.1)
    print(f"[quant] main ELL: k_regular plan, paper's config, d_max "
          f"{ell[1].shape[1]}, nnz {ell[0].nnz}")
    # deltas-sized values with a spread of magnitudes across rows
    X = torch.randn(n, p, generator=g, device=dev) * 10.0 ** -torch.randint(
        1, 5, (n, 1), generator=g, device=dev)
    for storage in ("int8", "int4", "fp8"):
        out = case("main", X, storage, dense, ell, timed=True)
        if storage == "int8":
            rows = out
    del X
    for storage in ("int8", "int4", "fp8"):
        case("ragged dense", torch.randn(13, 2048, generator=g, device=dev),
             storage, dense_of(13), None, timed=False)
        case("ragged hub", torch.randn(37, 2048, generator=g, device=dev),
             storage, None, ell_of("hub", 37, 1), timed=False)
    scale = ell_of("ring", 100_000, 12_500, hops=1)
    case("scale ring", torch.randn(100_000, 2048, generator=g, device=dev),
         "int8", None, scale, timed=True)
    torch.cuda.empty_cache()
    return [rows[k] for k in ("aggregate_dequant", "mix_aggregate_dequant",
                              "sparse_mix_aggregate_dequant")]


# the GEMVs' main-path payloads: (label, n, fp32 / bf16 width, quantized
# width); the scale round's (phase 4) is logreg's 7,850 params packed to
# 7,936 fp32 columns or 8,192 quantized ones (block 512)
GEMV_SHAPES = (("paper", 70, 1_663_488, 1_663_488),
               ("scale", 100_000, 7_936, 8_192))
# the quant block of the paper experiment's int8 run ([paper], phase 3c)
PAPER_BLOCK = 128


def phase_gemv(seed: int):
    """The two GEMVs (aggregate, aggregate_dequant) at every shape the main
    paths give them: the paper's (70 x 1,663,488; int8 also at block 128,
    [paper]'s, quantized on the card and held to the CPU quantizer
    bitwise) and the scale round's
    (100,000 x 7,936 fp32 / bf16, 100,000 x 8,192 int8 / int4 / fp8 at
    block 512), each held against its plain version and timed beside its
    bound and ``torch.matmul`` (for the dequant kernel: dequantize_group
    + torch.matmul, two calls), with the row groups G it splits n into."""
    import torch
    from repro_torch.fl import packing
    from repro_torch.kernels.mixing import fused, ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    f4, block = 4, 512
    # fp32 sums over up to 100,000 rows in another order than the plain
    # version's: roundings of ~2^-24 of partial sums far below 1
    tol = dict(rtol=1e-5, atol=1e-5)

    def report(tag, name, shape, kernel, plain_ms, yard, yard_ms, nbytes,
               flops, e, groups):
        ms = cuda_ms(kernel)
        b_ms, b_by = bound(nbytes, flops)
        print(f"[{tag}] {name} @ {shape}, G {groups}: {ms:.4f} ms (plain "
              f"{plain_ms:.4f} ms, {yard} {yard_ms:.4f} ms, bound "
              f"{b_ms:.4f} ms by {b_by}: {b_ms / ms:.1%} of it; "
              f"{nbytes / ms / 1e6:.0f} GB/s; max|err| {e:.3e}, rtol "
              f"{tol['rtol']:.1e}, atol {tol['atol']:.1e})"
              + (second_pass(kernel) if groups > 1 else ""))

    def second_pass(kernel):
        """The device time a call of the GEMV kernel and of the row
        groups' second pass, by torch.profiler over 5 calls."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                kernel()
            torch.cuda.synchronize()
        us = {"gemv_kernel": 0.0, "sum_groups_kernel": 0.0}
        for ev in prof.key_averages():
            for k in us:
                if k in ev.key:
                    us[k] += ev.self_device_time_total / 5
        return (f"; profiled: GEMV {us['gemv_kernel']:.1f} us + second pass "
                f"{us['sum_groups_kernel']:.1f} us a call")

    def check(name, kernel, want):
        """The kernel against its plain version, and a second call
        bitwise equal to the first."""
        got = kernel()
        e = float((got - want).abs().max())
        if not torch.allclose(got, want, **tol):
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"by {e:.3e}")
        if not torch.equal(got, kernel()):
            raise AssertionError(f"{name}: a second call differs")
        return e

    for label, n, p_f, p_q in GEMV_SHAPES:
        w = torch.rand(n, generator=g, device=dev) / n
        for dtype in (torch.float32, torch.bfloat16):
            X = torch.randn(n, p_f, generator=g, device=dev).to(dtype)
            # the yardstick takes w in X's dtype (one call; for bf16 its
            # output is bf16, the bytes it reads the same)
            yard = ("torch.matmul" if dtype == torch.float32
                    else "torch.matmul in bf16")
            kernel = partial(fused.aggregate_cuda, w, X)
            e = check("aggregate", kernel, ref.aggregate_ref(w, X))
            report("kernels", "aggregate", f"{label} ({n}, {p_f}) "
                   f"{str(dtype).split('.')[1]}", kernel,
                   cuda_ms(lambda: ref.aggregate_ref(w, X), iters=5),
                   yard, cuda_ms(lambda: torch.matmul(w.to(dtype), X),
                                 iters=10),
                   X.numel() * X.element_size() + n * f4 + p_f * f4,
                   2 * n * p_f, e, fused.aggregate_row_groups(X))
            del X
        X = torch.randn(n, p_q, generator=g, device=dev)
        # the paper experiment's int8 payload is at block 128 (4x the
        # scales of block 512); its quantizer is held to the CPU's there
        cases = [(storage, block) for storage in ("int8", "int4", "fp8")]
        if label == "paper":
            cases.append(("int8", PAPER_BLOCK))
        for storage, blk in cases:
            quant = packing.QuantSpec(storage=storage, block=blk)
            Xq, S = packing.quantize_group(X, quant)
            if blk != block:
                Xq_h, S_h = packing.quantize_group(X.cpu(), quant)
                if not (torch.equal(Xq.cpu(), Xq_h)
                        and torch.equal(S.cpu(), S_h)):
                    raise AssertionError(f"{label} {storage} block {blk}: "
                                         "the CUDA quantizer differs from "
                                         "the CPU's")
                del Xq_h, S_h
                print(f"[quant] {label} ({n}, {p_q}) {storage} block {blk}: "
                      "CUDA quantizer == CPU quantizer bitwise (containers "
                      "and scales)")
            q = dict(storage=storage, block=blk)
            kernel = partial(fused.aggregate_dequant_cuda, w, Xq, S, **q)
            e = check("aggregate_dequant", kernel,
                      ref.aggregate_dequant_ref(w, Xq, S, storage, blk))
            report("quant", "aggregate_dequant",
                   f"{label} ({n}, {p_q}) {storage}"
                   + (f" block {blk}" if blk != block else ""), kernel,
                   cuda_ms(lambda: ref.aggregate_dequant_ref(
                       w, Xq, S, storage, blk), iters=5),
                   "yardstick, two calls, dequantize_group + torch.matmul",
                   cuda_ms(lambda: torch.matmul(w, packing.dequantize_group(
                       Xq, S, quant)), iters=10),
                   Xq.numel() * Xq.element_size() + S.numel() * f4
                   + n * f4 + p_q * f4, n * p_q + 2 * n * p_q, e,
                   fused.aggregate_dequant_row_groups(Xq, S, **q))
            del Xq, S
        del X, w
        torch.cuda.empty_cache()


# -- phase 3 ----------------------------------------------------------------

def kernel_counters():
    """Every kernel wrapper by its report name; each counts its launches
    in ``.launches``."""
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


def flash_launches(cfg, steps: int) -> dict:
    """The flash kernels' launches that ``steps`` local-SGD steps of a
    model at ``cfg`` make on the card (a step: one ``grad``, of every
    client at once under ``vmap`` or of a rank's one client): a forward
    a GQA attention call (zamba2: a group's shared block), another for
    its recomputation under ``cfg.remat``, and a backward; none off the
    kernel route (not bf16, head dims over 128, MLA, no attention, the
    'ref' path)."""
    from repro_torch.models.blocks import hybrid_groups
    if cfg.dtype != "bfloat16" or cfg.attn_impl == "ref" or cfg.mla or \
            not cfg.uses_attention or cfg.resolved_head_dim > 128:
        return {}
    calls = hybrid_groups(cfg)[0] if cfg.family == "hybrid" \
        else cfg.n_layers
    return {"flash_attention": calls * (1 + bool(cfg.remat)) * steps,
            "flash_attention_bwd": calls * steps}


def reset_counters(counters) -> None:
    """Every wrapper's launch count, and route counts where it has them,
    to 0."""
    for f in counters.values():
        f.launches = 0
        if hasattr(f, "routes"):
            f.routes = dict.fromkeys(f.routes, 0)


def bookkeeping(h):
    """A History's plan-decided columns and its total cost."""
    return ([(r.t, r.m, r.m_actual, r.d2s, r.d2d, r.psi_bound, r.eta)
             for r in h.records], h.ledger.total_cost)


def paper_cell(seed: int):
    """The paper's Sec. 6 setting at full width: n = 70 clients in c = 7
    clusters, ``k_regular`` k in [6, 9] with p_fail = 0.1, label-sorted
    synthetic 28x28x1 data, the McMahan CNN, T = 5, batch 32.  Returns
    ``(n, c, T, ds_test, batcher, spec, loss_fn, init)``."""
    import numpy as np
    from repro_torch import topology
    from repro_torch.data import (FederatedBatcher, label_sorted_partition,
                                  make_classification)
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
    return n, c, T, ds_test, batcher, spec, loss_fn, cnn.init_cnn(seed)


def phase_train(rounds: int, seed: int):
    """Algorithm 1 at full width on every kernel backend; returns the
    launch count of each kernel in the path that runs it, and the routes
    of the routed kernels' launches there."""
    import torch
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.fl import packing
    from repro_torch.fl.engine import ExecutionConfig
    from repro_torch.models import cnn

    n, c, T, ds_test, batcher, spec, loss_fn, init = paper_cell(seed)
    n_params = sum(int(x.numel()) for x in tree_flatten(init)[0])
    pspec = packing.pack_spec({k: {kk: v[None] for kk, v in d.items()}
                               for k, d in init.items()})
    print(f"[train] CNN: {n_params:,} params, packed P_pad = "
          f"{pspec.padded:,}; X per round ({n}, {pspec.padded}) f32 = "
          f"{pspec.nbytes(n) / 1e6:.1f} MB")
    dev = torch.device("cuda")
    xs = torch.as_tensor(ds_test.x, device=dev)
    ys = torch.as_tensor(ds_test.y, device=dev).long()
    counters = kernel_counters()

    def server_for(backend, record_mixed, scan, quant=None):
        return FederatedServer(
            spec.build(), loss_fn, init,
            batcher, ServerConfig(T=T, t_max=rounds, seed=seed),
            execution=ExecutionConfig(backend=backend, scan=scan,
                                      record_mixed=record_mixed,
                                      quant=quant))

    def run(backend, record_mixed, scan, evaluate=True, quant=None):
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

        server = server_for(backend, record_mixed, scan, quant)
        reset_counters(counters)
        hist = server.run(eval_fn=eval_fn if evaluate else None)
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in counters.items()}
        routes = {k: dict(f.routes) for k, f in counters.items()
                  if hasattr(f, "routes")}
        if not evaluate:
            per_round = None
        elif scan:   # evals all run after the scanned trajectory
            per_round = [(stamps[1] - exits[0]) * 1e3 / rounds] * rounds
        else:
            per_round = [(stamps[t + 1] - exits[t]) * 1e3
                         for t in range(rounds)]
        return server, hist, counts, per_round, routes

    ref_server, ref_hist, ref_counts, ref_ms, _ = run("einsum", False, False)
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

    # launches a run must make: one a round per dtype group on the packed
    # paths, one a round per leaf on the leaf-wise 'pallas' path; the
    # staged route takes every launch of the packed (70, 1,663,488) f32
    # buffers and every leaf whose size fills whole 16-byte vectors
    # (p % 4 == 0: all but the 10-value bias of the last layer), the
    # generic route the rest (csrc/mixing.cu, csrc/sparse_mixing.cu)
    groups = pspec.n_groups
    leaf_p = [int(x.numel()) for x in tree_flatten(init)[0]]
    n_leaves = len(leaf_p)
    leaves_staged = sum(pl % 4 == 0 for pl in leaf_p)
    paths = [("fused", False, "aggregate", "aggregate", groups, None),
             ("fused", True, "fused", "mix_aggregate", groups, groups),
             ("pallas", True, "pallas", "mix", n_leaves, leaves_staged),
             ("sparse", False, "sparse_aggregate", "aggregate", groups,
              None),
             ("sparse", True, "sparse", "sparse_mix_aggregate", groups,
              groups)]
    launches, path_routes = {}, {}
    for backend, record_mixed, effective, kernel, per_round, staged in \
            paths:
        finals = {}
        for scan in (False, True):
            server, hist, counts, ms, routes = run(backend, record_mixed,
                                                   scan)
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
            if staged is not None:
                want = {"generic": (per_round - staged) * rounds,
                        "staged": staged * rounds}
                if routes[kernel] != want:
                    raise AssertionError(f"{kernel} on {effective}: routes "
                                         f"{routes[kernel]}, not {want}")
                total = path_routes.setdefault(kernel, dict.fromkeys(want, 0))
                for r in want:
                    total[r] += routes[kernel][r]
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
                  f"{counts[kernel]} {kernel} launches"
                  + (f" (routes {routes[kernel]})" if staged is not None
                     else "") + ", round ms "
                  f"{[round(x, 1) for x in ms]}, max|params - einsum| "
                  f"{worst:.3e}, test_acc {accs}")
        same = all(torch.equal(a, b) for a, b in zip(finals[False],
                                                     finals[True]))
        print(f"[train] {effective}: scanned == sequential bitwise: {same}")
        if not same:
            raise AssertionError(f"{effective}: scanned != sequential")
    print(f"[train] History bookkeeping equal across all backends; total "
          f"comm cost {ref_hist.ledger.total_cost:.1f} (D2S "
          f"{ref_hist.ledger.total_d2s}, D2D {ref_hist.ledger.total_d2d})")
    launches["sparse_mix"], path_routes["sparse_mix"] = mix_alone(
        loss_fn, init, batcher, spec, rounds, seed, counters)
    trace_device(lambda: run("fused", False, False, evaluate=False),
                 f"aggregate path, {rounds} sequential rounds (no eval)")
    quant_launches, quant_routes = train_quant(
        run, server_for, loss_fn, counters, groups, rounds)
    launches.update(quant_launches)
    path_routes.update(quant_routes)
    return launches, path_routes


def train_quant(run, server_for, loss_fn, counters, groups, rounds):
    """The quantized payload path at full width (error feedback on, block
    512): int8 on 'fused' (-> aggregate_dequant), 'fused' with
    record_mixed (-> mix_aggregate_dequant), 'sparse' (-> the ELL combine
    row and aggregate_dequant) and 'sparse' with record_mixed (->
    sparse_mix_aggregate_dequant), and int4 and fp8 on the default route,
    each scanned and sequential, against the quantized 'einsum' oracle of
    its storage.  Every mix_aggregate_dequant and
    sparse_mix_aggregate_dequant launch must take the staged route.
    Returns the dequant kernels' launches and the routed ones' routes."""
    import torch
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.fl import packing

    paths = [("int8", "fused", False, "aggregate", "aggregate_dequant"),
             ("int8", "fused", True, "fused", "mix_aggregate_dequant"),
             ("int8", "sparse", False, "sparse_aggregate",
              "aggregate_dequant"),
             ("int8", "sparse", True, "sparse",
              "sparse_mix_aggregate_dequant"),
             ("int4", "fused", False, "aggregate", "aggregate_dequant"),
             ("fp8", "fused", False, "aggregate", "aggregate_dequant")]
    oracles, launches, path_routes = {}, {}, {}
    for storage in ("int8", "int4", "fp8"):
        quant = packing.QuantSpec(storage=storage, block=512)
        srv, hist_srv = run("einsum", False, False, quant=quant)[:2]
        oracle_leaves, allow_leaves, quant_ms, shape = quant_replay(
            server_for("einsum", False, False, quant), loss_fn, quant,
            srv.params, storage)
        oracles[storage] = (hist_srv, oracle_leaves, allow_leaves)
        print(f"[train] quant {storage} (block 512, error feedback): einsum "
              f"oracle sequential, replayed bitwise; the plain-PyTorch "
              f"quantizer takes {quant_ms:.4f} ms of a round at {shape} "
              "(CUDA events, round 0's deltas)")
    for storage, backend, record_mixed, effective, kernel in paths:
        quant = packing.QuantSpec(storage=storage, block=512)
        hist_o, leaves_o, allow_o = oracles[storage]
        finals = {}
        for scan in (False, True):
            server, hist, counts, ms, routes = run(backend, record_mixed,
                                                   scan, quant=quant)
            if server.effective_backend != effective:
                raise AssertionError(
                    f"quant {backend} record_mixed={record_mixed} "
                    f"dispatched {server.effective_backend}")
            if counts[kernel] != groups * rounds or \
                    sum(counts.values()) != counts[kernel]:
                raise AssertionError(f"quant {effective}: launches "
                                     f"{counts}, expected {groups} "
                                     f"{kernel} a round")
            launches[kernel] = launches.get(kernel, 0) + counts[kernel]
            if kernel in routes:          # n = 70: all staged
                want = {"generic": 0, "staged": groups * rounds}
                if routes[kernel] != want:
                    raise AssertionError(f"quant {kernel} on {effective}: "
                                         f"routes {routes[kernel]}, not "
                                         f"{want}")
                total = path_routes.setdefault(kernel,
                                               dict.fromkeys(want, 0))
                for r in want:
                    total[r] += routes[kernel][r]
            if bookkeeping(hist) != bookkeeping(hist_o):
                raise AssertionError(f"quant {effective}: History "
                                     "bookkeeping differs from einsum")
            leaves = tree_flatten(server.params)[0]
            worst, flipped, _ = within_one_step(
                leaves, leaves_o, allow_o,
                f"quant {storage} {effective} scan={scan}")
            finals[scan] = leaves
            print(f"[train] quant {storage} {backend} "
                  f"record_mixed={record_mixed} -> {effective}, "
                  f"{'scanned' if scan else 'sequential'}: {counts[kernel]} "
                  f"{kernel} launches"
                  + (f" (routes {routes[kernel]})" if kernel in routes
                     else "")
                  + f", round ms {[round(x, 1) for x in ms]}, "
                  f"max|params - einsum| {worst:.3e} ({flipped} past rtol "
                  f"1e-4 / atol 1e-5, all within the one-step allowance), "
                  f"test_acc {[r.metrics['test_acc'] for r in hist.records]}")
        same = all(torch.equal(a, b) for a, b in zip(finals[False],
                                                     finals[True]))
        if not same:
            raise AssertionError(f"quant {storage} {effective}: scanned != "
                                 "sequential")
        print(f"[train] quant {storage} {effective}: scanned == sequential "
              f"bitwise: {same}")
    quant = packing.QuantSpec(storage="int8", block=512)
    trace_device(lambda: run("fused", False, False, evaluate=False,
                             quant=quant),
                 f"quant int8 aggregate path, {rounds} sequential rounds "
                 "(no eval)")
    return launches, path_routes


def quant_replay(server, loss_fn, quant, final, what, each_round=None):
    """A quantized 'einsum' server's run replayed round by round (the
    server's plan, batches and device columns), to learn each round's grid
    steps: a value within a few ulps of a rounding boundary can round the
    other way on a kernel path, whose mixing sums in another order, and
    moves the aggregate by at most |w_i| * step_i.  The replay must end
    on ``final``, the params of the same oracle run through its server,
    bitwise.  Returns ``(oracle_leaves, allow_leaves, quant_ms, shape)``:
    the allowance summed over the rounds, leaf by leaf, and the ms of the
    plain-PyTorch quantizer on round 0's packed payload of ``shape``.
    ``each_round``, a list, gets ``(oracle_leaves, allow_leaves)`` after
    every round."""
    import torch
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.core.rounds import client_deltas, make_round_fn
    from repro_torch.fl import packing
    from repro_torch.fl.engine import (ExecutionConfig, _device_columns,
                                       _quant_setup, _to_device)
    from repro_torch.kernels.mixing import ops

    dev = torch.device("cuda")
    plan, batches = server._plan_and_batches()
    A_seq, tau_seq, m_seq, eta_seq, active_seq = _device_columns(plan, dev)
    params = _to_device(server.params, dev)
    n = plan.n_clients
    _, qs = _quant_setup(ExecutionConfig(quant=quant), plan, params,
                         "einsum", dev)
    round_fn = make_round_fn(loss_fn, "einsum", quant=quant)
    allow, quant_ms = 0.0, None
    for t in range(plan.n_rounds):
        batch = _to_device(batches[t], dev)
        active = None if active_seq is None else active_seq[t]
        deltas = client_deltas(loss_fn, params, batch, eta_seq[t])
        pspec = packing.pack_spec(deltas, quant=quant)
        bufs = packing.pack(deltas, pspec)
        x = bufs[0] + qs[0][0]
        steps = x.reshape(n, -1, quant.block).abs().amax(2) / quant.qmax
        wrow = ops.combine_weights(A_seq[t], tau_seq[t], m_seq[t], active)
        allow = allow + wrow.abs() @ steps
        if quant_ms is None:
            quant_ms = cuda_ms(lambda: packing.quantize_packed(
                bufs, pspec, qs[0]), iters=10)
        params, _, qs = round_fn(params, batch, A_seq[t], tau_seq[t],
                                 m_seq[t], eta_seq[t], active, qs)
        if each_round is not None:
            each_round.append((tree_flatten(params)[0], tree_flatten(
                packing.unpack_row(allow.repeat_interleave(quant.block),
                                   pspec))[0]))
    torch.cuda.synchronize()
    oracle_leaves = tree_flatten(params)[0]
    if not all(_same_bits(a, b)
               for a, b in zip(oracle_leaves, tree_flatten(final)[0])):
        raise AssertionError(f"{what}: the replayed einsum oracle differs "
                             "from the server's")
    allow_leaves = tree_flatten(packing.unpack_row(
        allow.repeat_interleave(quant.block), pspec))[0]
    return oracle_leaves, allow_leaves, quant_ms, (n, pspec.padded)


def within_one_step(leaves, leaves_o, allow_o, what, nonfinite=False):
    """[train]'s quant rule: each value within rtol 1e-4 / atol 1e-5 of the
    quantized einsum oracle's or, where a rounding decision flipped,
    within the one-step allowance ``allow_o`` (one grid step times the
    combine weight, summed over the rounds) on top.  With ``nonfinite``
    a run that diverged is held too: its NaN / inf values must lie where
    the oracle's do and equal them, and the rule holds the finite rest.
    Returns ``(worst, flipped, finite)``: the largest difference, the
    values past rtol / atol and the values compared."""
    import torch
    worst, flipped, finite = 0.0, 0, 0
    for a, b, c in zip(leaves, leaves_o, allow_o):
        ok = torch.isfinite(a)
        if a.shape != b.shape or not (nonfinite or ok.all()):
            raise AssertionError(f"{what}: bad params")
        if not (torch.equal(ok, torch.isfinite(b))
                and _same_bits(a[~ok], b[~ok])):
            raise AssertionError(f"{what}: non-finite params differ from "
                                 "the oracle's")
        a, b, c = a[ok], b[ok], c[ok]
        d = (a - b).abs()
        plain = d <= 1e-5 + 1e-4 * b.abs()
        if not (plain | (d <= c + 1e-5 + 1e-4 * b.abs())).all():
            raise AssertionError(
                f"{what}: params differ from einsum by "
                f"{float(d.max()):.3e}, past the one-step allowance")
        flipped += int((~plain).sum())
        finite += int(a.numel())
        if a.numel():
            worst = max(worst, float(d.max()))
    return worst, flipped, finite


def _same_bits(a, b) -> bool:
    """``torch.equal`` that takes NaN for equal to NaN."""
    import torch
    return torch.equal(a.isnan(), b.isnan()) and \
        torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))


def mix_alone(loss_fn, init, batcher, spec, rounds, seed, counters):
    """Eq. 3 alone at full width, as a caller of the public op computes
    it: the first round's client deltas (the server's first batch, the
    plan's first step size) mixed by ``ops.sparse_mix`` with the ELL of
    the sparse plan's first round, against the dense oracle
    ``rounds.mix_deltas``.  Returns the sparse_mix launches and their
    routes (all staged)."""
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
    reset_counters(counters)
    mixed = [ops.sparse_mix(idx, w, b) for b in bufs]
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in counters.items()}
    routes = dict(counters["sparse_mix"].routes)
    if counts["sparse_mix"] != pspec.n_groups or \
            sum(counts.values()) != counts["sparse_mix"] or \
            routes != {"generic": 0, "staged": pspec.n_groups}:
        raise AssertionError(f"eq. 3 alone launched {counts}, routes "
                             f"{routes}")
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
          f"{counts['sparse_mix']} sparse_mix launch(es) (routes {routes}), "
          f"max|mixed - dense oracle| {worst:.3e}")
    return counts["sparse_mix"], routes


def device_events(prof):
    """The device events of a finished ``torch.profiler`` run, read from
    its exported trace (``build/profile_trace.json``): ``(raw, events,
    busy_us)`` -- every kernel / copy / set event, the same kept once per
    correlation id (one per launch), and the union of their intervals in
    µs (events overlapping on several streams count once)."""
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
    return raw, events, busy_us


def trace_device(fn, what: str, top: int = 12, warm: bool = True):
    """Trace ``fn()`` (``what``) with ``torch.profiler``, device activity
    only, after one untraced call (unless ``warm`` is False), and print the device events (kernels,
    copies, sets) by total time and the device's busy share of the traced
    wall time.  Events are read from the exported trace and kept once per
    correlation id (one per launch); the busy time is the union of their
    intervals, so events overlapping on several streams count once."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()                                 # warm: cuDNN / vmap set-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    raw, events, busy_us = device_events(prof)
    per_name, per_stream = {}, {}
    for e in events:
        count, us = per_name.get(e["name"], (0, 0.0))
        per_name[e["name"]] = (count + 1, us + e["dur"])
        sid = e.get("args", {}).get("stream", e.get("tid"))
        count, us = per_stream.get(sid, (0, 0.0))
        per_stream[sid] = (count + 1, us + e["dur"])
    total = sum(us for _, us in per_name.values()) / 1e3
    busy = busy_us / 1e3
    print(f"[profile] {what}, device activity traced: wall "
          f"{wall_ms:.1f} ms, device "
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


# -- phase 3b: the closed loop, the heterogeneous optimizers, the quickstart --

# (controller, topology family, backend, record_mixed, the kernel its
# path launches: once a round, the CNN's deltas being one fp32 group)
CONTROL_RUNS = (
    ("static", "k_regular", "fused", False, "aggregate"),
    ("threshold:tau=2", "k_regular", "fused", True, "mix_aggregate"),
    ("threshold:scheme=sampled", "k_regular", "sparse", True,
     "sparse_mix_aggregate"),
    ("threshold:tau=2", "k_regular", "sparse", True,
     "sparse_mix_aggregate"),
    ("similarity", "learned", "fused", False, "aggregate"),
)


def phase_control(rounds: int, seed: int):
    """The closed loop at the paper's width (the [train] configuration;
    ``similarity`` over a ``learned:k=3`` topology of the same n and c):
    each controller of ``CONTROL_RUNS`` drives ``FederatedServer.run(
    controller=)`` on its kernel backend with the launch counts reset just
    before and read just after.  Its realized plan replayed through
    ``run(plan=)`` must reproduce it bitwise with the same launches and
    routes (and, on 'sparse', extra ELL padding slots must change
    nothing); the same controller on 'einsum' must realize the same plan
    (a sparse run's: einsum replays it), with params within rtol 1e-4 /
    atol 1e-5; ``static`` must equal the precomputed
    ``connectivity_aware`` plan's run bitwise.  Prints the
    round times (host clock) and the ``similarity`` feed's ms (the
    device-to-host copy of a round's deltas, the controller's ``feed``,
    and its cast and Gram timed apart).  Returns
    the kernels' launch counts and routes in the live runs."""
    import numpy as np
    import torch
    from repro_torch import control, topology
    from repro_torch.core.pytree import tree_flatten, tree_leaves
    from repro_torch.core.rounds import client_deltas
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.fl.engine import ExecutionConfig, _to_device
    from repro_torch.fl.plan import RoundPlan
    from repro_torch.models import cnn

    n, c, T, ds_test, batcher, spec, loss_fn, init = paper_cell(seed)
    specs = {"k_regular": spec,
             "learned": topology.make_spec("learned", n=n, c=c, k=3)}
    cfg = ServerConfig(T=T, t_max=rounds, seed=seed)
    dev = torch.device("cuda")
    xs = torch.as_tensor(ds_test.x, device=dev)
    ys = torch.as_tensor(ds_test.y, device=dev).long()
    counters = kernel_counters()

    def server_for(family, backend, record_mixed):
        return FederatedServer(
            specs[family].build(), loss_fn, init, batcher, cfg,
            execution=ExecutionConfig(backend=backend,
                                      record_mixed=record_mixed))

    def run(family, backend, record_mixed, **how):
        """One run with the counts reset before it and read after it:
        ``(server, history, counts, routes, round ms)``."""
        stamps, exits = [time.perf_counter()], []
        exits.append(stamps[0])

        def eval_fn(p):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            out = {"test_acc": cnn.accuracy(cnn.cnn_apply, p, xs, ys)}
            torch.cuda.synchronize()
            exits.append(time.perf_counter())
            return out

        server = server_for(family, backend, record_mixed)
        reset_counters(counters)
        hist = server.run(eval_fn=eval_fn, **how)
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in counters.items()}
        routes = {k: dict(f.routes) for k, f in counters.items()
                  if hasattr(f, "routes")}
        ms = [(stamps[t + 1] - exits[t]) * 1e3 for t in range(rounds)]
        return server, hist, counts, routes, ms

    def records(h):
        return [(r.t, r.m, r.m_actual, r.psi_bound, r.d2s, r.d2d, r.eta,
                 r.metrics) for r in h.records]

    launches, path_routes = {}, {}
    for ctl, family, backend, record_mixed, kernel in CONTROL_RUNS:
        what = f"{ctl} on {backend}" + (" + record_mixed" if record_mixed
                                        else "") + f" ({family})"
        feed_ms = []
        controller = control.build(control.parse_spec(ctl))
        if controller.needs_deltas:
            feed = controller.feed

            def timed_feed(record, deltas, feed=feed):
                t0 = time.perf_counter()
                feed(record, deltas)
                feed_ms.append((time.perf_counter() - t0) * 1e3)

            controller.feed = timed_feed
        live, h_live, counts, routes, ms = run(family, backend, record_mixed,
                                               controller=controller)
        plan = live.last_plan
        want = rounds
        if counts[kernel] != want or sum(counts.values()) != want:
            raise AssertionError(f"[control] {what}: launches {counts}, "
                                 f"not {want} of {kernel}")
        if kernel in routes and routes[kernel] != {"generic": 0,
                                                   "staged": want}:
            raise AssertionError(f"[control] {what}: {kernel} routes "
                                 f"{routes[kernel]}, not all staged")
        if any(r.control is None for r in h_live.records) != \
                (ctl == "static"):
            raise AssertionError(f"[control] {what}: telemetry missing")
        launches[kernel] = launches.get(kernel, 0) + counts[kernel]
        if kernel in routes:
            total = path_routes.setdefault(kernel, dict.fromkeys(
                routes[kernel], 0))
            for r in total:
                total[r] += routes[kernel][r]

        # the realized plan replays bitwise, through the same kernels
        replay, h_rep, r_counts, r_routes, _ = run(family, backend,
                                                   record_mixed, plan=plan)
        same = all(torch.equal(a, b) for a, b in zip(
            tree_leaves(live.params), tree_leaves(replay.params)))
        if not same or records(h_live) != records(h_rep) or \
                r_counts != counts or r_routes != routes or \
                any(r.control is not None for r in h_rep.records):
            raise AssertionError(f"[control] {what}: the replay of the "
                                 f"realized plan differs (params equal: "
                                 f"{same}, launches {r_counts}, routes "
                                 f"{r_routes})")
        if plan.is_sparse:
            padding_is_inert(plan, loss_fn, init, batcher, seed)
        if ctl == "static":
            pre, h_pre, _, _, _ = run(
                family, backend, record_mixed,
                plan=RoundPlan.connectivity_aware(specs[family].build(),
                                                  cfg))
            if records(h_pre) != records(h_live) or not all(
                    torch.equal(a, b) for a, b in zip(
                        tree_leaves(pre.params), tree_leaves(live.params))):
                raise AssertionError("[control] static controller differs "
                                     "from the precomputed plan")
        # the same controller on the plain einsum backend.  A dense loop
        # must realize the same plan; a sparse one computes realized phi
        # on the CSR (power iteration) where einsum's dense loop takes an
        # SVD, which agree to ~1e-6, not bitwise, so einsum replays the
        # sparse run's realized plan (densified) instead
        how = ({"plan": plan} if plan.is_sparse else {"controller": ctl})
        oracle, h_ref, ref_counts, _, _ = run(family, "einsum", False,
                                              **how)
        if any(ref_counts.values()):
            raise AssertionError(f"einsum launched kernels: {ref_counts}")
        if [r[:7] for r in records(h_ref)] != \
                [r[:7] for r in records(h_live)] or (
                    not plan.is_sparse and (
                        oracle.last_plan.to_json() != plan.to_json()
                        or [r.control for r in h_ref.records]
                        != [r.control for r in h_live.records])):
            raise AssertionError(f"[control] {what}: einsum realized "
                                 "another plan")
        worst = 0.0
        for a, b in zip(tree_flatten(live.params)[0],
                        tree_flatten(oracle.params)[0]):
            if a.shape != b.shape or not torch.isfinite(a).all() or \
                    not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"[control] {what}: params differ "
                                     "from einsum")
            worst = max(worst, float((a - b).abs().max()))
        d_max = ((max(plan.A_t.max_degree, 1),
                  [int(m.row_degrees.max()) for m in plan.A_t])
                 if plan.is_sparse else None)
        print(f"[control] {what}: m {[r.m_actual for r in h_live.records]}"
              f", d2d {[r.d2d for r in h_live.records]}, "
              f"{counts[kernel]} {kernel} launches"
              + (f" (routes {routes[kernel]})" if kernel in routes else "")
              + (f", ELL d_max live {d_max[1]} / replay {d_max[0]}"
                 if d_max else "")
              + f"; replay bitwise: {same}; max|params - einsum| "
              f"{worst:.3e}; round ms {[round(x, 1) for x in ms]} (mean "
              f"after round 0 {np.mean(ms[1:]):.1f}); telemetry "
              f"{h_live.records[-1].control}; test_acc "
              f"{[r.metrics['test_acc'] for r in h_live.records]}")
        if feed_ms:
            # the device-to-host copy that execute_controlled makes of a
            # round's deltas, timed alone on round 0's inputs
            params = _to_device(init, dev)
            b0 = _to_device(batcher(np.random.default_rng([seed, 1]), 0),
                            dev)
            eta = torch.tensor(plan.eta_t[0], dtype=torch.float32,
                               device=dev)
            tree = client_deltas(loss_fn, params, b0, eta)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            flat = np.concatenate([leaf.reshape(n, -1).cpu().numpy()
                                   for leaf in tree_leaves(tree)], axis=1)
            copy_ms = (time.perf_counter() - t0) * 1e3
            # the feed's two steps on that copy, timed apart: the float64
            # cast and row normalisation, then the Gram alone
            t0 = time.perf_counter()
            X = np.asarray(flat, np.float64)
            norms = np.linalg.norm(X, axis=1)
            norms[norms == 0.0] = 1.0
            X = X / norms[:, None]
            t1 = time.perf_counter()
            X @ X.T
            t2 = time.perf_counter()
            print(f"[control] similarity feed: ({n}, {flat.shape[1]}) fp32 "
                  f"= {flat.nbytes / 1e6:.1f} MB to the host in "
                  f"{copy_ms:.1f} ms; the controller's feed (host numpy: "
                  f"float64 cast, normalisation, Gram, EMA, graph "
                  f"rebuild) {[round(x, 1) for x in feed_ms]} ms a round; "
                  f"of it, on round 0's deltas, cast + normalisation "
                  f"{(t1 - t0) * 1e3:.1f} ms, Gram {(t2 - t1) * 1e3:.1f} ms")
            del tree, flat, X
        del live, replay, oracle
        torch.cuda.empty_cache()
    return launches, path_routes


def padding_is_inert(plan, loss_fn, init, batcher, seed):
    """A live controlled round's ELL is as wide as its own widest row, the
    replay's as the plan's widest; the extra slots (index 0, weight 0.0)
    must change nothing.  Round 0's packed deltas through
    ``sparse_mix_aggregate_cuda`` with the round's own ELL and with 6 more
    padding slots (another template bound of the slot loop): both outputs
    bitwise equal, both launches on one route."""
    import numpy as np
    import torch
    from repro_torch.core.rounds import client_deltas
    from repro_torch.fl import packing
    from repro_torch.fl.engine import _to_device
    from repro_torch.kernels.mixing import sparse

    dev = torch.device("cuda")
    b0 = _to_device(batcher(np.random.default_rng([seed, 1]), 0), dev)
    eta = torch.tensor(plan.eta_t[0], dtype=torch.float32, device=dev)
    deltas = client_deltas(loss_fn, _to_device(init, dev), b0, eta)
    X = packing.pack(deltas, packing.pack_spec(deltas))[0]
    wrow = torch.rand(X.shape[0], device=dev)
    d = int(plan.A_t[0].row_degrees.max())
    outs = []
    for width in (d, d + 6):
        idx, w = (torch.as_tensor(a, device=dev)
                  for a in plan.A_t[0].ell(width))
        outs.append(routed(sparse.sparse_mix_aggregate_cuda, idx, w, wrow,
                           X))
    (m1, a1), r1 = outs[0]
    (m2, a2), r2 = outs[1]
    if not (torch.equal(m1, m2) and torch.equal(a1, a2)) or r1 != r2:
        raise AssertionError(f"ELL padding slots changed the result (d_max "
                             f"{d} on {r1}, {d + 6} on {r2})")
    print(f"[control]   ELL d_max {d} and {d + 6} (6 padding slots) on "
          f"{X.shape[0]} x {X.shape[1]}: mixed and agg bitwise equal, both "
          f"{r1}")


def phase_hetero(seed: int):
    """``HeteroClientOptimizers`` at the paper's width (the McMahan CNN, n =
    70, T = 5, batch 32) on the card: an all-'sgd' runner against
    ``client_deltas`` (rtol 1e-6, atol 1e-7), then two 'sgd,adam'
    instances fed the same dispatch order (two ``deltas`` calls each on
    the same inputs: the 'sgd' clients repeat, the 'adam' ones move on),
    bitwise equal, with the ms a call."""
    import numpy as np
    import torch
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.core.rounds import client_deltas
    from repro_torch.fl.engine import _to_device
    from repro_torch.optim import HeteroClientOptimizers, parse_client_optim

    n, _, T, _, batcher, _, loss_fn, init = paper_cell(seed)
    dev = torch.device("cuda")
    params = _to_device(init, dev)
    # the same inputs twice: the 'sgd' clients must repeat themselves and
    # the 'adam' clients (odd indices) move on with their state
    b0 = _to_device(batcher(np.random.default_rng([seed, 1]), 0), dev)
    rounds = [b0, b0]
    eta = 0.02

    sgd = HeteroClientOptimizers(loss_fn, params,
                                 parse_client_optim("sgd", n))
    got = sgd.deltas(params, rounds[0], eta)
    want = client_deltas(loss_fn, params, rounds[0],
                         torch.tensor(eta, dtype=torch.float32, device=dev))
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        if not torch.allclose(a, b, rtol=1e-6, atol=1e-7):
            raise AssertionError("[hetero] all-sgd differs from "
                                 "client_deltas")
        worst = max(worst, float((a - b).abs().max()))
    del sgd, got, want

    def calls():
        h = HeteroClientOptimizers(loss_fn, params,
                                   parse_client_optim("sgd,adam", n))
        h.warmup(params, rounds[0], eta)
        out, ms = [], []
        for b in rounds:
            t0 = time.perf_counter()
            d = h.deltas(params, b, eta)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(tree_leaves(d))
        return h, out, ms

    h1, out1, ms1 = calls()
    h2, out2, ms2 = calls()
    same = all(torch.equal(a, b) for r1, r2 in zip(out1, out2)
               for a, b in zip(r1, r2)) and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(h1.states),
                                          tree_leaves(h2.states)))
    adam = h1.states["adam"]
    state_bytes = sum(x.numel() * x.element_size() for x in
                      tree_leaves(h1.states))
    first, second = out1[0][0], out1[1][0]
    advanced = (torch.equal(first[0::2], second[0::2])
                and not torch.equal(first[1::2], second[1::2]))
    print(f"[hetero] all-sgd vs client_deltas: max|diff| {worst:.3e} "
          f"(rtol 1e-6, atol 1e-7); sgd,adam: groups "
          f"{list(h1.states)}, adam steps {int(adam.count[0])} a client, "
          f"state {state_bytes / 1e9:.3f} GB on the card; second instance "
          f"bitwise equal: {same}; on the same inputs again sgd repeated and "
          f"adam moved: {advanced}; ms a call {[round(x, 1) for x in ms1]} / "
          f"{[round(x, 1) for x in ms2]}")
    if not same or not advanced or int(adam.count[0]) != 2 * T or \
            any(not torch.isfinite(x).all() for x in out1[-1]):
        raise AssertionError("[hetero] heterogeneous runner is not "
                             "deterministic or did not advance")
    del h1, h2, out1, out2
    torch.cuda.empty_cache()


def _load_example(name):
    """``examples/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_quickstart(counters):
    """``examples/quickstart_torch.py`` once on the card, its table
    printed; its m(t) / psi / D2D columns must be the port's plan's and
    its accuracies finite.  Returns the aggregate launches of its run."""
    import math
    from repro_torch import topology
    from repro_torch.core.server import ServerConfig
    from repro_torch.fl.plan import RoundPlan

    reset_counters(counters)
    server, hist = _load_example("quickstart_torch").main(
        ["--device", "cuda"])
    counts = {k: f.launches for k, f in counters.items()}
    rounds = len(hist.records)
    plan = RoundPlan.connectivity_aware(
        topology.make_spec("k_regular", n=20, c=2, k_range=(6, 9),
                           p_fail=0.1).build(),
        ServerConfig(T=5, t_max=rounds, phi_max=2.0))
    cols = [(r.m_actual, r.psi_bound, r.d2d) for r in hist.records]
    if cols != list(zip(plan.m_actual_t.tolist(),
                        plan.psi_bound_t.tolist(), plan.d2d_t.tolist())) \
            or any(not math.isfinite(r.metrics["acc"])
                   for r in hist.records) \
            or counts["aggregate"] != rounds \
            or sum(counts.values()) != rounds:
        raise AssertionError(f"[quickstart] table or launches wrong: "
                             f"{counts}")
    print(f"[quickstart] examples/quickstart_torch.py on cuda: {rounds} "
          f"rounds, {counts['aggregate']} aggregate launches, m(t) / psi "
          f"/ D2D equal the plan's, final acc "
          f"{hist.records[-1].metrics['acc']:.3f}")
    return counts["aggregate"]


# the experiment's D2S cases: [paper] runs both, and holds the
# semidec-int8 run of each against its quantized einsum oracle
PAPER_CASES = ("high", "low")
PAPER_ROUNDS = 15   # the twin's default --rounds
# the twin's runs in order: (row, algorithm, CASES key of m_fixed, bound
# kind, quantized)
PAPER_RUNS = (("semidec", "semidec", None, "auto", False),
              ("semidec-exact", "semidec", None, "exact", False),
              ("semidec-int8", "semidec", None, "auto", True),
              ("fedavg", "fedavg", "m_fedavg", "auto", False),
              ("colrel", "colrel", "m_colrel", "auto", False))


def _timed_runs(experiment, counters, log):
    """``experiment`` (the twin's) with every server it builds run under a
    clock and fresh kernel counts: each ``server.run`` appends ``{server,
    hist, wall_s, round_ms, counts, finite, rounds}`` to ``log`` (a
    round's ms: from the end of the previous round's evaluation to the
    start of its own; ``finite``: whether each round's params are;
    ``rounds``: a quantized run's params after each round, for [paper]'s
    oracle)."""
    import torch
    from repro_torch.core.pytree import tree_flatten

    def timed(server):
        inner = server.run
        keep = server.execution.quant is not None

        def run(eval_fn=None, **kw):
            stamps, exits, finite, rounds = [], [], [], []

            def timed_eval(p):
                torch.cuda.synchronize()
                stamps.append(time.perf_counter())
                out = eval_fn(p)
                leaves = tree_flatten(p)[0]
                finite.append(all(bool(torch.isfinite(x).all())
                                  for x in leaves))
                if keep:
                    rounds.append([x.detach().clone() for x in leaves])
                torch.cuda.synchronize()
                exits.append(time.perf_counter())
                return out

            reset_counters(counters)
            exits.append(time.perf_counter())
            hist = inner(eval_fn=timed_eval, **kw)
            torch.cuda.synchronize()
            log.append(dict(
                server=server, hist=hist,
                wall_s=time.perf_counter() - exits[0],
                round_ms=[(a - b) * 1e3 for a, b in zip(stamps, exits)],
                counts={k: f.launches for k, f in counters.items()},
                finite=finite, rounds=rounds))
            return hist
        server.run = run
        return server

    def wrapped(*args, **kwargs):
        exp = experiment(*args, **kwargs)
        make = exp.make_server
        exp.make_server = lambda *a, **k: timed(make(*a, **k))
        return exp
    return wrapped


def phase_paper(counters):
    """``examples/fl_paper_experiment_torch.py`` on the card at its
    defaults (the paper's CNN, n = 70, c = 7, T = 5, batch 16, 15 rounds),
    both cases: (a) its rows, summary and savings, wall s and ms a round
    per run; (b) each row's plan and byte columns exactly those of the
    host's ``RoundPlan`` for its algorithm, bound kind and m_fixed and of
    the packed layout's arithmetic, every accuracy finite in [0, 1], one
    aggregate_dequant launch a round on the semidec-int8 run and no
    launch elsewhere; (c) the semidec-int8 run against its quantized
    einsum oracle, built with the twin's own ``experiment``, by [train]'s
    quant rule.  Returns the aggregate_dequant launches."""
    import inspect
    import math

    import numpy as np
    import torch
    from repro_torch import topology
    from repro_torch.core.metrics import CommLedger
    from repro_torch.core.pytree import tree_flatten
    from repro_torch.core.server import ServerConfig
    from repro_torch.fl.plan import RoundPlan
    from repro_torch.models import cnn

    t_phase = time.perf_counter()
    twin = _load_example("fl_paper_experiment_torch")
    experiment, log = twin.experiment, []
    twin.experiment = _timed_runs(experiment, counters, log)
    # the twin's setting: n = 70 clients in c = 7 clusters, T = 5
    setting = {k: v.default for k, v in inspect.signature(
        experiment).parameters.items()}
    rounds, n, c, T = (PAPER_ROUNDS, setting["n"], setting["clusters"],
                       setting["T"])
    # the packed layout's arithmetic: the CNN's leaves in one fp32 group,
    # padded to 128 columns; int8 stores a byte a value and an fp32 scale
    # a block of PAPER_BLOCK
    P = sum(int(x.numel()) for x in tree_flatten(cnn.init_cnn(SEED))[0])
    P_pad = -(-P // 128) * 128
    bytes_fp32, bytes_int8 = 4 * P_pad, P_pad + P_pad // PAPER_BLOCK * 4
    ctors = {"semidec": RoundPlan.connectivity_aware,
             "fedavg": RoundPlan.fedavg, "colrel": RoundPlan.colrel}
    launches = 0
    for case in PAPER_CASES:
        log.clear()
        t0 = time.perf_counter()
        rows = twin.main(["--device", "cuda", "--case", case,
                          "--rounds", str(rounds)])
        case_s = time.perf_counter() - t0
        cfg = twin.CASES[case]
        if [r["algorithm"] for r in rows] != [x[0] for x in PAPER_RUNS] \
                or len(log) != len(PAPER_RUNS):
            raise AssertionError(f"[paper] {case}: runs {rows}")
        for row, entry, (name, algorithm, m_key, bound_kind, quantized) in \
                zip(rows, log, PAPER_RUNS):
            m_fixed = None if m_key is None else cfg[m_key]
            plan = ctors[algorithm](
                topology.make_spec("k_regular", n=n, c=c, k_range=(6, 9),
                                   p_fail=cfg["p"]).build(),
                ServerConfig(T=T, t_max=rounds, phi_max=cfg["phi_max"],
                             m_fixed=m_fixed, seed=setting["seed"],
                             bound_kind=bound_kind))
            ledger = CommLedger()
            for d2s, d2d in zip(plan.d2s_t, plan.d2d_t):
                ledger.add_round(d2s, d2d)
            pb = bytes_int8 if quantized else bytes_fp32
            want = dict(total_d2s=ledger.total_d2s,
                        total_d2d=ledger.total_d2d,
                        total_cost=float(ledger.total_cost),
                        mean_m=float(np.mean(plan.m_actual_t)),
                        payload_bytes_per_upload=pb,
                        uplink_bytes=ledger.total_d2s * pb)
            got = {k: row[k] for k in want}
            accs = [r.metrics["test_acc"] for r in entry["hist"].records]
            counts = entry["counts"]
            kernel_runs = counts["aggregate_dequant"] if quantized else 0
            backend = "aggregate" if quantized else "einsum"
            print(f"[paper] {case} {name}: {json.dumps(row)}")
            finite = entry["finite"]
            print(f"[paper] {case} {name}: {entry['wall_s']:.2f} s wall, "
                  f"{np.mean(entry['round_ms'][1:]):.2f} ms a round after "
                  f"the first (round 0 {entry['round_ms'][0]:.1f} ms; "
                  f"{entry['server'].effective_backend} backend), launches "
                  f"{ {k: v for k, v in counts.items() if v} }; params "
                  + ("finite after every round" if all(finite) else
                     f"finite after {finite.index(False)} of {rounds} "
                     "rounds, then not"))
            if got != want:
                raise AssertionError(f"[paper] {case} {name}: columns {got}"
                                     f" differ from the host plan's {want}")
            if not all(math.isfinite(a) and 0.0 <= a <= 1.0
                       for a in accs + [row["final_acc"]]):
                raise AssertionError(f"[paper] {case} {name}: accuracies "
                                     f"{accs}")
            if entry["server"].effective_backend != backend \
                    or sum(counts.values()) != kernel_runs \
                    or kernel_runs != (rounds if quantized else 0):
                raise AssertionError(f"[paper] {case} {name}: launches "
                                     f"{counts} on {backend}")
            launches += kernel_runs
        if any(rows[2][k] != rows[0][k] for k in
               ("total_d2s", "total_d2d", "total_cost", "mean_m")):
            raise AssertionError(f"[paper] {case}: semidec-int8's plan "
                                 "differs from semidec's")
        print(f"[paper] {case}: 5 runs in {case_s:.1f} s; every row's "
              "plan and byte columns equal the host plan's and the packed "
              f"layout's ({bytes_fp32:,} B fp32 / {bytes_int8:,} B int8 an "
              f"upload); {launches} aggregate_dequant launches so far, "
              "none of any other kernel")
        # (c) the semidec-int8 run against its quantized einsum oracle,
        # from the twin's own construction (not timed, not counted), after
        # every round: a run that diverges is held to the oracle's
        # non-finite values and, before that, by the rule
        t0 = time.perf_counter()
        int8_run, each = log[2], []
        exp = experiment(case, rounds, "cnn", device="cuda")
        reset_counters(counters)
        oracle = exp.make_server("semidec", quant=exp.int8,
                                 backend="einsum")
        hist_o = oracle.run()
        quant_ms, shape = quant_replay(
            exp.make_server("semidec", quant=exp.int8, backend="einsum"),
            exp.loss_fn, exp.int8, oracle.params, f"[paper] {case}",
            each_round=each)[2:]
        if any(f.launches for f in counters.values()):
            raise AssertionError("[paper] the einsum oracle launched "
                                 "kernels")
        if bookkeeping(int8_run["hist"]) != bookkeeping(hist_o):
            raise AssertionError(f"[paper] {case}: semidec-int8's History "
                                 "bookkeeping differs from its oracle's")
        if len(int8_run["rounds"]) != rounds or len(each) != rounds:
            raise AssertionError(f"[paper] {case}: {len(each)} oracle "
                                 f"rounds, {len(int8_run['rounds'])} kept")
        worst, flipped, compared = 0.0, 0, []
        for t, (leaves, (leaves_o, allow_o)) in enumerate(
                zip(int8_run["rounds"], each)):
            w, f, k = within_one_step(
                leaves, leaves_o, allow_o,
                f"[paper] {case} semidec-int8 round {t}", nonfinite=True)
            worst, flipped = max(worst, w), flipped + f
            compared.append(k)
        if not compared[0]:
            raise AssertionError(f"[paper] {case}: no finite value to hold "
                                 "after round 0")
        print(f"[paper] {case} semidec-int8 against the quantized einsum "
              f"oracle (int8, block {exp.int8.block}, error feedback; "
              f"replayed bitwise), after each of {rounds} rounds: "
              f"bookkeeping equal, finite values compared a round "
              f"{compared} (the rest non-finite where the oracle's are), "
              f"max|params - einsum| {worst:.3e} ({flipped} past rtol 1e-4 "
              "/ atol 1e-5, all within the one-step allowance); the plain "
              f"quantizer {quant_ms:.4f} ms at {shape}; "
              f"{time.perf_counter() - t0:.1f} s")
    twin.experiment = experiment
    log.clear()
    torch.cuda.empty_cache()
    print(f"[paper] phase: {time.perf_counter() - t_phase:.1f} s, "
          f"{launches} aggregate_dequant launches")
    return launches


# -- phase 3c: the semi-async and wall-clock runtimes -------------------------

STREAM_ROUNDS = 4   # enough rounds for a stale cohort to form
# the fault process and the closure policy of [stream] and [ingest]
STREAM_FAULTS = "markov:p_fail=0.2,latency=exponential,mean=0.5"
STREAM_POLICY = dict(buffer=40, deadline=2.0, staleness="poly")
# [ingest]: wall seconds a virtual time unit, so that the mean upload
# latency (0.5 units = 0.1 s) is near one round's compute at this width
INGEST_TIME_SCALE = 0.2


def _stream_records(h, metrics=True):
    """A History's records as comparable tuples (nan psi as a string)."""
    return [(r.t, r.m, r.m_actual,
             "nan" if r.psi_bound != r.psi_bound else r.psi_bound,
             r.d2s, r.d2d, r.eta, r.stream)
            + ((r.metrics,) if metrics else ()) for r in h.records]


def phase_stream(rounds: int, seed: int) -> int:
    """The semi-async runtime at the paper's width (the [train]
    configuration, ``rounds`` rounds), through
    ``FederatedServer(execution=ExecutionConfig(stream=...))``: a
    pristine ``StreamConfig()`` on 'fused' must equal ``LocalEngine``
    'fused' bitwise with the same launches; under ``STREAM_FAULTS`` with
    ``STREAM_POLICY`` 'fused' must take the stale path, keep History
    bitwise the 'einsum' run's and params within rtol 1e-4 / atol 1e-5,
    and its realized plan replayed fault-free must reproduce it bitwise;
    the same with ``client_optim='sgd,adam'``; ``threshold:tau=2``
    closed-loop under the same faults, replayed bitwise.  Prints each
    run's round ms after round 0 (host clock) and aggregate launches;
    returns the aggregate launches of the runs that are not replays."""
    import numpy as np
    import torch
    from repro_torch.core.pytree import tree_flatten, tree_leaves
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.fl.engine import ExecutionConfig
    from repro_torch.fl.faults import parse_fault_spec
    from repro_torch.fl.stream import StreamConfig, StreamEngine
    from repro_torch.models import cnn

    n, c, T, ds_test, batcher, spec, loss_fn, init = paper_cell(seed)
    cfg = ServerConfig(T=T, t_max=rounds, seed=seed)
    dev = torch.device("cuda")
    xs = torch.as_tensor(ds_test.x, device=dev)
    ys = torch.as_tensor(ds_test.y, device=dev).long()
    counters = kernel_counters()
    faults = parse_fault_spec(STREAM_FAULTS)

    def run(backend, stream, **how):
        """One run with the counts reset before it and read after it:
        ``(server, history, counts, round ms)``."""
        stamps, exits = [time.perf_counter()], []
        exits.append(stamps[0])

        def eval_fn(p):
            torch.cuda.synchronize()
            stamps.append(time.perf_counter())
            out = {"test_acc": cnn.accuracy(cnn.cnn_apply, p, xs, ys)}
            torch.cuda.synchronize()
            exits.append(time.perf_counter())
            return out

        server = FederatedServer(
            spec.build(), loss_fn, init, batcher, cfg,
            execution=ExecutionConfig(backend=backend, stream=stream))
        reset_counters(counters)
        hist = server.run(eval_fn=eval_fn, **how)
        torch.cuda.synchronize()
        counts = {k: f.launches for k, f in counters.items()}
        ms = [(stamps[t + 1] - exits[t]) * 1e3 for t in range(rounds)]
        return server, hist, counts, ms

    def same_params(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            tree_leaves(a.params), tree_leaves(b.params)))

    def only_aggregate(counts, what):
        if sum(counts.values()) != counts["aggregate"]:
            raise AssertionError(f"[stream] {what}: launches {counts}")
        return counts["aggregate"]

    def report(what, hist, counts, ms, extra=""):
        late = sum(r.stream.get("late", 0) for r in hist.records
                   if r.stream)
        print(f"[stream] {what}: m {[r.m_actual for r in hist.records]}, "
              f"late {late:g}, {counts['aggregate']} aggregate launches, "
              f"round ms {[round(x, 1) for x in ms]} (mean after round 0 "
              f"{np.mean(ms[1:]):.1f}){extra}; test_acc "
              f"{[round(r.metrics['test_acc'], 4) for r in hist.records]}")

    launches = 0
    # 1) pristine: bitwise the synchronous engine, the same launches
    sync, h_sync, c_sync, ms_sync = run("fused", None)
    semi, h_semi, c_semi, ms_semi = run("fused", StreamConfig())
    if not isinstance(semi.engine, StreamEngine) or \
            semi.effective_backend != "aggregate":
        raise AssertionError("[stream] the server did not run the stream "
                             "engine on 'aggregate'")
    if not same_params(sync, semi) or \
            _stream_records(h_sync) != _stream_records(h_semi) or \
            only_aggregate(c_semi, "pristine") != \
            only_aggregate(c_sync, "LocalEngine") or \
            c_semi["aggregate"] != rounds:
        raise AssertionError(f"[stream] pristine StreamConfig() differs from "
                             f"LocalEngine (launches {c_semi} vs {c_sync})")
    report("LocalEngine fused", h_sync, c_sync, ms_sync)
    report("pristine StreamConfig() fused", h_semi, c_semi, ms_semi,
           "; == LocalEngine bitwise (params, History, launches)")
    launches += c_semi["aggregate"]
    del sync, semi

    # 2) - 3) faults on fused: stale path, einsum, realized-plan replay
    for optim in (None, "sgd,adam"):
        stream = StreamConfig(faults=faults, client_optim=optim,
                              **STREAM_POLICY)
        what = f"{STREAM_FAULTS}, {STREAM_POLICY}" + (
            f", client_optim={optim!r}" if optim else "")
        live, h_live, c_live, ms_live = run("fused", stream)
        only_aggregate(c_live, what)
        if not any(r.stream and r.stream.get("late") for r in
                   h_live.records):
            raise AssertionError(f"[stream] {what}: no stale cohort")
        oracle, h_ref, c_ref, _ = run("einsum", stream)
        if any(c_ref.values()):
            raise AssertionError(f"einsum launched kernels: {c_ref}")
        if _stream_records(h_live, False) != _stream_records(h_ref, False):
            raise AssertionError(f"[stream] {what}: History differs from "
                                 "einsum")
        worst = 0.0
        for a, b in zip(tree_flatten(live.params)[0],
                        tree_flatten(oracle.params)[0]):
            if not torch.isfinite(a).all() or \
                    not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                raise AssertionError(f"[stream] {what}: params differ "
                                     "from einsum")
            worst = max(worst, float((a - b).abs().max()))
        realized = live.engine.last_realized_plan
        replay, h_rep, c_rep, _ = run(
            "fused", StreamConfig(client_optim=optim, **STREAM_POLICY),
            plan=realized)
        if not same_params(live, replay) or \
                _stream_records(h_live) != _stream_records(h_rep) or \
                c_rep != c_live:
            raise AssertionError(f"[stream] {what}: the realized plan's "
                                 f"replay differs (launches {c_rep})")
        report(what, h_live, c_live, ms_live,
               f"; max|params - einsum| {worst:.3e}; realized plan replayed "
               f"fault-free bitwise, {c_rep['aggregate']} launches")
        launches += c_live["aggregate"]
        del live, oracle, replay

    # 4) closed loop on the stream runtime, under the same faults
    stream = StreamConfig(faults=faults, **STREAM_POLICY)
    live, h_live, c_live, ms_live = run("fused", stream,
                                        controller="threshold:tau=2")
    only_aggregate(c_live, "threshold:tau=2")
    replay, h_rep, c_rep, _ = run("fused", StreamConfig(**STREAM_POLICY),
                                  plan=live.last_plan)
    if not same_params(live, replay) or c_rep != c_live or \
            _stream_records(h_live) != _stream_records(h_rep) or \
            any(r.control is None for r in h_live.records):
        raise AssertionError("[stream] threshold:tau=2: the realized plan's "
                             f"replay differs (launches {c_rep})")
    report("threshold:tau=2 under the same faults", h_live, c_live,
           ms_live, f"; realized plan replayed bitwise, "
           f"{c_rep['aggregate']} launches; telemetry "
           f"{h_live.records[-1].control}")
    launches += c_live["aggregate"]
    del live, replay
    torch.cuda.empty_cache()
    return launches


def phase_ingest(rounds: int, seed: int) -> int:
    """The wall-clock runtime at the paper's width: ``IngestEngine``
    (clock 'wall', ``INGEST_TIME_SCALE`` s a unit, 4 workers) under
    ``STREAM_FAULTS`` / ``STREAM_POLICY`` on 'fused', with and without
    overlapping dispatch, each traced with ``torch.profiler`` (device
    activity only).  Its ``Recording`` must verify bitwise on the card,
    and every overlapped cohort's payload event must have completed when
    its future resolved.  Prints wall seconds, rounds closed, late / lost
    / duplicate uploads, aggregate launches, how far past their drawn
    latency the uploads landed (ms) and the device's busy share of the
    traced wall time; then runs both CLIs' ``--selfcheck`` on cuda.
    Returns the aggregate launches of the two live runs."""
    import os
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.fl.engine import ExecutionConfig
    from repro_torch.fl.faults import parse_fault_spec
    from repro_torch.fl.stream import StreamConfig
    from repro_torch.runtime import IngestEngine, RuntimeConfig

    n, c, T, _, batcher, spec, loss_fn, init = paper_cell(seed)
    cfg = ServerConfig(T=T, t_max=rounds, seed=seed)
    dev = torch.device("cuda")
    counters = kernel_counters()
    stream = StreamConfig(faults=parse_fault_spec(STREAM_FAULTS),
                          **STREAM_POLICY)

    def server_for(runtime):
        return FederatedServer(
            spec.build(), loss_fn, init, batcher, cfg,
            execution=ExecutionConfig(backend="fused", stream=stream,
                                      runtime=runtime))

    launches = 0
    for overlap in (True, False):
        runtime = RuntimeConfig(clock="wall", time_scale=INGEST_TIME_SCALE,
                                workers=4, overlap=overlap)
        server = server_for(runtime)
        if not isinstance(server.engine, IngestEngine):
            raise AssertionError("[ingest] the server did not run "
                                 "IngestEngine")
        reset_counters(counters)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            hist = server.run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        counts = {k: f.launches for k, f in counters.items()}
        _, events, busy_us = device_events(prof)
        eng = server.engine
        rec = eng.last_recording
        # the live run's batches: a fresh server's seeded stream
        _, batches = server_for(None)._plan_and_batches(rec.plan)
        problems = rec.verify(loss_fn, init, batches, backend="fused",
                              device=dev)
        ready = eng.last_payload_ready
        want_ready = dict.fromkeys(range(rounds), True) if overlap else {}
        tally = {k: sum(r.stream.get(k, 0) for r in hist.records
                        if r.stream) for k in ("late", "lost", "dup")}
        # how much later than its drawn latency each upload landed while
        # the run was open: the payload's compute (overlap: the timers
        # start at payload-ready) and the timers' own lateness, in ms.
        # The uploads the shutdown flushed early, past the last closure,
        # are left out
        measured = rec.plan.arrival_t
        drawn = eng.last_trace.arrival[:rec.plan.n_rounds]
        dispatched = np.array([0.0] + rec.closures[:-1])[:, None]
        landed = np.isfinite(drawn) & np.isfinite(measured) & \
            (dispatched + measured <= rec.closures[-1])
        extra = (measured - drawn)[landed] * INGEST_TIME_SCALE * 1e3
        lateness = (f"{extra.size} uploads landed in the run {extra.mean():.1f}"
                    f" ms past their drawn latency on average (min "
                    f"{extra.min():.1f}, max {extra.max():.1f})"
                    if extra.size else "no upload landed in the run")
        print(f"[ingest] wall clock, overlap={overlap}, time_scale "
              f"{INGEST_TIME_SCALE} s a unit: {rec.meta['wall_seconds']:.3f}"
              f" s wall in the loop ({wall_ms / 1e3:.3f} s with set-up), "
              f"{len(hist.records)} rounds closed, m "
              f"{[r.m_actual for r in hist.records]}, late {tally['late']:g}"
              f", lost {tally['lost']:g}, dup {tally['dup']:g}, "
              f"{counts['aggregate']} aggregate launches (2 of them the "
              f"warm-up's); {lateness}; device busy {busy_us / 1e3:.1f} of "
              f"{wall_ms:.1f} ms traced ({busy_us / 1e3 / wall_ms:.1%}, "
              f"{len(events)} device events); Recording.verify() "
              f"{problems}; payload events complete at resolution: "
              f"{sorted(ready.items())}")
        if problems or ready != want_ready or \
                sum(counts.values()) != counts["aggregate"] or \
                len(hist.records) != rounds:
            raise AssertionError(f"[ingest] overlap={overlap}: verify "
                                 f"{problems}, payload events {ready}, "
                                 f"launches {counts}")
        launches += counts["aggregate"]
        del server, eng
        torch.cuda.empty_cache()

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", f"repro_torch.launch.{cli}", "--selfcheck",
         "--device", "cuda", "--backend", "fused"], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cli in ("stream", "ingest")]
    try:
        for cli, proc in zip(("stream", "ingest"), procs):
            out = proc.communicate(timeout=300)[0].strip()
            print(f"[ingest] python -m repro_torch.launch.{cli} --selfcheck"
                  f" --device cuda --backend fused: {out}")
            if proc.returncode != 0:
                raise AssertionError(f"launch.{cli} --selfcheck failed")
    finally:
        for proc in procs:           # stop what is still running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return launches


# -- phase 4 ----------------------------------------------------------------

def phase_scale(seed: int):
    """One round of the logreg model at n = 100,000 on both sparse
    backends and on 'sparse' with an int8 payload (block 512), from a plan
    built sparse (nothing (n, n) anywhere); each aggregate GEMV launch
    prints its row groups G."""
    import torch
    from functools import partial as _partial
    from repro_torch import topology
    from repro_torch.core.pytree import tree_flatten, tree_map
    from repro_torch.core.rounds import client_deltas
    from repro_torch.core.server import ServerConfig
    from repro_torch.fl import packing
    from repro_torch.fl.engine import ExecutionConfig, _to_device, make_engine
    from repro_torch.fl.plan import RoundPlan
    from repro_torch.kernels.mixing import fused, ops, sparse
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
    meta = tree_map(lambda x: torch.empty((n,) + tuple(x.shape),
                                          dtype=x.dtype, device="meta"),
                    init)
    int8 = packing.QuantSpec(storage="int8", block=512)
    P = packing.pack_spec(meta).padded
    Pq = packing.pack_spec(meta, quant=int8).padded
    # the GEMVs' row groups at this round's payloads, from the shapes alone
    groups = {
        fused.aggregate_cuda: fused.aggregate_row_groups(
            torch.empty(n, P, device="meta")),
        fused.aggregate_dequant_cuda: fused.aggregate_dequant_row_groups(
            torch.empty(n, Pq, dtype=torch.int8, device="meta"),
            torch.empty(n, Pq // 512, device="meta"), storage="int8",
            block=512)}
    finals = {}
    for record_mixed, quant, counter in (
            (False, None, fused.aggregate_cuda),
            (True, None, sparse.sparse_mix_aggregate_cuda),
            (False, int8, fused.aggregate_dequant_cuda)):
        eng = make_engine(ExecutionConfig(backend="sparse",
                                          record_mixed=record_mixed,
                                          quant=quant), loss_fn)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters({"counter": counter})
        t0 = time.perf_counter()
        final, hist = eng.execute(plan, init, [batch])
        torch.cuda.synchronize()
        round_ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        if hist.records[0].d2d != n or counter.launches != 1:
            raise AssertionError(f"{eng.backend}: d2d "
                                 f"{hist.records[0].d2d}, "
                                 f"{counter.launches} launches")
        routes = getattr(counter, "routes", None)
        if routes is not None and routes["generic"] != 1:
            raise AssertionError(f"n = {n} takes the generic route, not "
                                 f"{routes}")
        if peak >= n * n * 4:
            raise AssertionError(f"peak {peak / 1e9:.1f} GB: an (n, n) "
                                 "array was allocated")
        leaves = tree_flatten(final)[0]
        if not all(torch.isfinite(x).all() for x in leaves):
            raise AssertionError(f"{eng.backend}: non-finite params")
        finals[record_mixed, quant] = leaves
        print(f"[scale] {eng.backend}"
              + ("" if quant is None else f" {quant.storage}")
              + f": one round {round_ms:.1f} ms (first "
              f"call, host clock), peak device memory {peak / 1e9:.2f} GB, "
              f"d2d {hist.records[0].d2d}, {counter.launches} "
              f"{counter.__name__} launch"
              + (f" (routes {routes})" if routes is not None else "")
              + (f" (G {groups[counter]})" if counter in groups else ""))
    worst = max(float((a - b).abs().max())
                for a, b in zip(finals[False, None], finals[True, None]))
    if not all(torch.allclose(a, b, rtol=1e-5, atol=1e-6)
               for a, b in zip(finals[False, None], finals[True, None])):
        raise AssertionError(f"the sparse backends disagree by {worst:.3e}")
    print(f"[scale] sparse_aggregate and sparse agree: max|diff| "
          f"{worst:.3e}")
    # the int8 round against the fp32 one: the payloads differ by at most
    # half a grid step a value, so the params by at most one step times
    # the combine weight, summed over the clients (as in [train])
    deltas = client_deltas(loss_fn, _to_device(init, dev), batch,
                           torch.tensor(float(plan.eta_t[0]), device=dev))
    qspec = packing.pack_spec(deltas, quant=int8)
    x = packing.pack(deltas, qspec)[0]
    steps = x.reshape(n, -1, 512).abs().amax(2) / int8.qmax
    del deltas, x
    idx, w = (torch.as_tensor(a[0], device=dev) for a in plan.A_t.ell())
    wrow = ops.combine_weights_ell(
        idx, w, torch.as_tensor(plan.tau_t[0], device=dev),
        torch.tensor(float(plan.m_t[0]), device=dev))
    allow = tree_flatten(packing.unpack_row(
        (wrow.abs() @ steps).repeat_interleave(512), qspec))[0]
    worst, flipped = 0.0, 0
    for a, b, c in zip(finals[False, int8], finals[False, None], allow):
        d = (a - b).abs()
        if not (d <= c + 1e-5 + 1e-4 * b.abs()).all():
            raise AssertionError(f"the int8 scale round differs from the "
                                 f"fp32 one by {float(d.max()):.3e}, past "
                                 "one grid step")
        worst = max(worst, float(d.max()))
        flipped += int((d > 1e-5 + 1e-4 * b.abs()).sum())
    print(f"[scale] sparse_aggregate int8 against fp32: max|diff| "
          f"{worst:.3e} ({flipped} past rtol 1e-4 / atol 1e-5, all within "
          f"one grid step)")


# -- phase 5: the LM slice ----------------------------------------------------

# qwen2-7b's attention at the prefill shape the [lm] phase drives
LM_ARCH, LM_BATCH, LM_SEQ, LM_NEW = "qwen2-7b", 2, 2048, 16


def phase_flash(seed: int):
    """The flash-attention kernel against its plain version
    (``flash_attention_ref``): bf16 (the tensor-core route) at qwen2-7b's
    and phi3.5-moe's prefill shapes, and at a [tp] rank's heads (qwen2-7b
    14 / 2, qwen3-32b 16 / 2), in the model's layout (strided
    (B, H, S, hd) views of (B, S, H, hd) tensors) and contiguous, at head
    dims 32 / 64 / 128, S under one tile and ragged, GQA groups
    1 / 3 / 4 / 7 / 8, windows 1 / 16 /
    100 / 256, non-causal, kv tails and Sq != Sk; fp32 (the CUDA-core
    route) at head dims 32 / 64 / 128 (tolerances the reference's own:
    2e-5 fp32, 2e-2 bf16).  Each case prints the route the library
    reports it launched.  Then the kernel's time at qwen2-7b's shape
    beside the plain version's, the bound and
    ``scaled_dot_product_attention`` as the yardstick.  Returns the report
    row (launch count filled in by the [lm] phase)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.fl.engine import set_fp32_policy
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref

    set_fp32_policy()          # the plain version's fp32 matmuls: no TF32
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    bf, f32 = torch.bfloat16, torch.float32
    tol = {f32: 2e-5, bf: 2e-2}
    route_of = {bf: "tensor_cores", f32: "cuda_cores"}
    # (label, B, Hq, Hkv, Sq, Sk, hd, dtype, causal, window, true_seq_k,
    #  layout); Sk None = Sq; 'bshd' passes (B, S, H, hd) tensors as their
    # transposed views, as the model does
    cases = [
        ("qwen2-7b prefill, model layout", LM_BATCH, 28, 4, LM_SEQ, None,
         128, bf, True, None, None, "bshd"),
        ("qwen2-7b prefill, contiguous", LM_BATCH, 28, 4, LM_SEQ, None, 128,
         bf, True, None, None, "bhsd"),
        ("ragged S", 1, 28, 4, 1000, None, 128, bf, True, None, None,
         "bshd"),
        ("S 1, hd 32, group 8", 2, 8, 1, 1, None, 32, bf, True, None, None,
         "bhsd"),
        ("S 17, hd 64, group 3", 1, 6, 2, 17, None, 64, bf, True, None,
         None, "bhsd"),
        ("S 257, hd 64, group 7, window 1", 2, 7, 1, 257, None, 64, bf,
         True, 1, None, "bhsd"),
        ("hd 32, group 8", 1, 8, 1, 1000, None, 32, bf, True, None, None,
         "bshd"),
        ("hd 64, group 1", 2, 4, 4, 777, None, 64, bf, True, None, None,
         "bshd"),
        ("window 16, group 8", 1, 8, 1, 1000, None, 128, bf, True, 16, None,
         "bshd"),
        ("window 100", 2, 8, 2, 777, None, 128, bf, True, 100, None,
         "bhsd"),
        ("window 256", 1, 28, 4, 2048, None, 128, bf, True, 256, None,
         "bshd"),
        ("non-causal", 2, 8, 2, 333, None, 128, bf, False, None, None,
         "bshd"),
        ("kv tail: 900 of 1024 keys", 1, 4, 2, 1024, None, 64, bf, True,
         None, 900, "bhsd"),
        ("kv tail: 0 of 1024 keys", 1, 4, 2, 1024, None, 128, bf, False,
         None, 0, "bhsd"),
        ("Sq 300 < Sk 517, non-causal", 1, 6, 2, 300, 517, 64, bf, False,
         None, None, "bshd"),
        ("Sq 517 > Sk 300, causal", 1, 4, 1, 517, 300, 128, bf, True, None,
         None, "bhsd"),
        ("non-causal f32", 2, 4, 4, 200, None, 64, f32, False, None, None,
         "bhsd"),
        ("f32 hd 32, group 1", 2, 4, 4, 515, None, 32, f32, True, None, None,
         "bshd"),
        ("f32 hd 32, group 8, window 100", 1, 8, 1, 400, None, 32, f32, True,
         100, None, "bhsd"),
        ("f32 hd 64, group 3", 1, 6, 2, 777, None, 64, f32, True, None, None,
         "bhsd"),
        ("f32 hd 128, group 7", 1, 7, 1, 130, None, 128, f32, True, None,
         None, "bhsd"),
        ("f32 kv tail: 900 of 1024 keys", 1, 4, 2, 1024, None, 64, f32,
         True, None, 900, "bhsd"),
        ("f32 kv tail, non-causal, 1 of 64 keys", 1, 2, 1, 64, None, 32, f32,
         False, None, 1, "bhsd"),
        # head dims the kernels run zero-padded: zamba2's 80 (-> 128)
        ("phi3.5-moe prefill, model layout", LM_BATCH, 32, 8, LM_SEQ, None,
         128, bf, True, None, None, "bshd"),
        # a rank's heads under [tp]: qwen2-7b at m = 2, qwen3-32b at m = 4
        ("qwen2-7b prefill, a rank's heads at m = 2", LM_BATCH, 14, 2,
         LM_SEQ, None, 128, bf, True, None, None, "bshd"),
        ("qwen3-32b prefill, a rank's heads at m = 4", LM_BATCH, 16, 2,
         LM_SEQ, None, 128, bf, True, None, None, "bshd"),
        ("zamba2-2.7b shared block, hd 80", LM_BATCH, 32, 32, LM_SEQ, None,
         80, bf, True, None, None, "bshd"),
        ("hd 80, group 4, window 100", 1, 8, 2, 777, None, 80, bf, True, 100,
         None, "bhsd"),
        ("hd 48, group 3, kv tail 900 of 1024", 1, 6, 2, 1024, None, 48, bf,
         True, None, 900, "bshd"),
        ("f32 hd 80, group 1", 2, 4, 4, 515, None, 80, f32, True, None, None,
         "bshd"),
        ("f32 hd 80, group 8, window 16", 1, 8, 1, 300, None, 80, f32, True,
         16, None, "bhsd"),
    ]

    def draw(B, H, S, hd, dt, layout):
        if layout == "bshd":
            return torch.randn(B, S, H, hd, generator=g,
                               device=dev).to(dt).transpose(1, 2)
        return torch.randn(B, H, S, hd, generator=g, device=dev).to(dt)

    main_err = None
    for (label, B, Hq, Hkv, Sq, Sk, hd, dt, causal, window, tsk,
         layout) in cases:
        Sk = Sq if Sk is None else Sk
        q = draw(B, Hq, Sq, hd, dt, layout)
        k = draw(B, Hkv, Sk, hd, dt, layout)
        v = draw(B, Hkv, Sk, hd, dt, layout)
        kw = dict(causal=causal, window=window, true_seq_k=tsk)
        routes = dict(fa.flash_attention_cuda.routes)
        got = fa.flash_attention_cuda(q, k, v, **kw)
        route = [r for r in routes
                 if fa.flash_attention_cuda.routes[r] != routes[r]]
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        hp = fa.padded_head_dim(hd)     # the (B, Sq, Hq, hp) buffer's view
        ok = got.dtype == dt and route == [route_of[dt]] and \
            got.shape == (B, Hq, Sq, hd) and got.stride(3) == 1 and \
            got.stride(2) == Hq * hp and got.stride(1) == hp and \
            torch.allclose(
                got.float(), want.float(), rtol=tol[dt], atol=tol[dt])
        print(f"[flash] {label}: ({B}, {Hq}/{Hkv}, {Sq}/{Sk}, {hd}) {dt} "
              f"{layout} causal={causal} window={window} true_seq_k={tsk}: "
              f"route {route}, max|err| {e:.3e} (rtol = atol = "
              f"{tol[dt]:.0e})")
        if not ok:
            raise AssertionError(f"flash_attention {label} disagrees with "
                                 "its plain version or took another route")
        if main_err is None:
            main_err = e
            print(f"[flash]   qwen2-7b prefill max|err| {e:.3e} (the "
                  "CUDA-core kernel it replaces: 9.8e-4 to 2.0e-3)")
        del q, k, v, got, want

    B, Hq, Hkv, S, hd = LM_BATCH, 28, 4, LM_SEQ, 128
    q = draw(B, Hq, S, hd, bf, "bshd")          # the model's layout
    k = draw(B, Hkv, S, hd, bf, "bshd")
    v = draw(B, Hkv, S, hd, bf, "bshd")
    ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    plain_ms = cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True),
                       iters=5)
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), iters=10)
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    lib_c_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        qc, kc, vc, is_causal=True, enable_gqa=True), iters=10)
    pairs = S * (S + 1) // 2                 # visible (query, key) pairs
    flops = 4 * B * Hq * hd * pairs          # QK and PV, 2 flops a MAC
    nbytes = 2 * (2 * B * Hq * S * hd + 2 * B * Hkv * S * hd)
    b_ms, b_by = bound(nbytes, flops, BF16_TC_FLOPS_PER_S)
    issued = 3 * flops // 2                  # PV twice: p_hi and p_lo
    print(f"[flash] flash_attention @ qwen2-7b prefill ({B}, {Hq}/{Hkv}, "
          f"{S}, {hd}) bf16 causal, model layout: {ms:.4f} ms (plain "
          f"{plain_ms:.4f} ms, scaled_dot_product_attention {lib_ms:.4f} ms "
          f"on the same views, {lib_c_ms:.4f} ms on contiguous copies; "
          f"kernel / library {ms / lib_ms:.2f}x; bound {b_ms:.4f} ms by "
          f"{b_by} at the bf16 tensor-core peak: {b_ms / ms:.1%} of it); "
          f"{flops / 1e9:.1f} GFLOP of the function ({flops / ms / 1e9:.1f} "
          f"TFLOP/s), {issued / 1e9:.1f} GFLOP issued to the tensor cores "
          f"with the split PV ({issued / ms / 1e9:.1f} TFLOP/s), "
          f"{nbytes / 1e6:.1f} MB")
    del q, k, v, qc, kc, vc
    # zamba2-2.7b's shared block: head dim 80, run zero-padded to 128
    B, Hq, S, hd = LM_BATCH, 32, LM_SEQ, 80
    q, k, v = (draw(B, Hq, S, hd, bf, "bshd") for _ in range(3))
    ms80 = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True))
    lib80 = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=10)
    flops80 = 4 * B * Hq * hd * pairs
    b80, by80 = bound(2 * 4 * B * Hq * S * hd, flops80, BF16_TC_FLOPS_PER_S)
    print(f"[flash] flash_attention @ zamba2-2.7b shared block ({B}, "
          f"{Hq}/{Hq}, {S}, {hd} run at 128) bf16 causal, model layout: "
          f"{ms80:.4f} ms with the three pad copies (scaled_dot_product_"
          f"attention {lib80:.4f} ms; kernel / library {ms80 / lib80:.2f}x; "
          f"bound {b80:.4f} ms by {by80}: {b80 / ms80:.1%} of it)")
    del q, k, v
    torch.cuda.empty_cache()
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/"
                        "flash_attention.py:104",
            "launches": 0, "max_abs_err": main_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


# the stablelm-2-1.6b training cell's attention (BENCHMARK.json's
# stablelm2.fedtrain_4k): its 4 clients folded into the batch, 32 heads of
# 64, 4,096 tokens, causal
FLASH_BWD_CELL = (4, 32, 32, 4096, 64)
# (label, B, Hq, Hkv, S, hd)
FLASH_BWD_CASES = (
    ("stablelm-2-1.6b training cell", *FLASH_BWD_CELL),
    ("hd 128, GQA group 4", 1, 32, 8, 2048, 128),
    ("zamba2's hd 80 (run at 128), GQA group 2", 1, 32, 16, 2048, 80),
)


def phase_flash_bwd(seed: int):
    """The flash backward kernels (``flash_attention_bwd_cuda``) against
    their plain version (``flash_attention_bwd_ref``) fed the kernel
    forward's o and lse, bf16 in the model's layout, causal: at the
    stablelm-2-1.6b training cell's shape, at head dim 128 with GQA and
    at zamba2's 80 (run at 128).  Each output, and the forward's, lies
    within one bf16 ulp of its largest value of the plain version's:
    max|got - want| <= 2^-7 max|want| (the plain versions run a batch
    row at a time: their fp32 scores); the lse within 1e-4; a second
    backward call gives the same bits.  Then the backward's time at the
    cell's shape beside the plain version's, its bound (five products at
    the bf16 tensor-core peak) and ``scaled_dot_product_attention``'s
    forward + backward less its forward as the yardstick.  Returns the
    report row (its max|err| the cell's; launch count filled in by the
    training phases)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention import ref

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 5)

    def draw(B, H, S, hd):
        return torch.randn(B, S, H, hd, generator=g,
                           device=dev).to(torch.bfloat16).transpose(1, 2)

    def by_row(fn, *ts):
        """``fn`` over one batch row at a time, concatenated."""
        outs = [fn(*(t[b:b + 1] for t in ts)) for b in range(ts[0].shape[0])]
        if isinstance(outs[0], torch.Tensor):
            return torch.cat(outs)
        return tuple(torch.cat(parts) for parts in zip(*outs))

    def ulps(got, want):
        return float((got.float() - want.float()).abs().max()) / \
            float(want.float().abs().max())

    worst = 0.0
    for label, B, Hq, Hkv, S, hd in FLASH_BWD_CASES:
        q, k, v, do = draw(B, Hq, S, hd), draw(B, Hkv, S, hd), \
            draw(B, Hkv, S, hd), draw(B, Hq, S, hd)
        o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
        want_o, want_lse = by_row(
            lambda *a: ref.flash_attention_ref(*a, with_lse=True), q, k, v)
        e_o, e_lse = ulps(o, want_o), float((lse - want_lse).abs().max())
        got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
        want = by_row(ref.flash_attention_bwd_ref, q, k, v, o, lse, do)
        errs = [ulps(a, b) for a, b in zip(got, want)]
        again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do)
        same = all(torch.equal(a, b) for a, b in zip(got, again))
        torch.cuda.synchronize()
        print(f"[flash_bwd] {label}: ({B}, {Hq}/{Hkv}, {S}, {hd}) bf16 "
              f"causal: o {e_o:.2e}, lse {e_lse:.2e}; "
              f"dq, dk, dv {', '.join(f'{e:.2e}' for e in errs)} of the "
              f"largest value (limit {2 ** -7:.2e}, lse 1e-4); a second "
              f"call bitwise equal: {same}")
        if max(errs + [e_o]) > 2 ** -7 or e_lse > 1e-4 or not same:
            raise AssertionError(f"flash_attention_bwd {label} disagrees "
                                 "with its plain version or repeats "
                                 "differently")
        if label == FLASH_BWD_CASES[0][0]:
            worst = max(float((a.float() - b.float()).abs().max())
                        for a, b in zip(got, want))
        del q, k, v, do, o, lse, want_o, want_lse, got, want, again
        torch.cuda.empty_cache()

    B, Hq, Hkv, S, hd = FLASH_BWD_CELL
    q, k, v, do = draw(B, Hq, S, hd), draw(B, Hkv, S, hd), \
        draw(B, Hkv, S, hd), draw(B, Hq, S, hd)
    fwd_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v,
                                                     with_lse=True))
    o, lse = fa.flash_attention_cuda(q, k, v, with_lse=True)
    ms = cuda_ms(lambda: fa.flash_attention_bwd_cuda(q, k, v, o, lse, do))
    plain_ms = cuda_ms(lambda: by_row(ref.flash_attention_bwd_ref, q, k, v,
                                      o, lse, do), iters=2, warmup=1)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))

    def lib_both():
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True).backward(
            do)

    lib_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), iters=10)
    lib_ms = cuda_ms(lib_both, iters=10) - lib_fwd
    pairs = S * (S + 1) // 2
    flops = 10 * B * Hq * hd * pairs     # s, dp, dv, dq, dk: 2 flops a MAC
    nbytes = 2 * 4 * (B * Hq + B * Hkv) * S * hd + 2 * 4 * B * Hq * S
    b_ms, b_by = bound(nbytes, flops, BF16_TC_FLOPS_PER_S)
    print(f"[flash_bwd] flash_attention_bwd @ the stablelm-2-1.6b training "
          f"cell ({B}, {Hq}/{Hkv}, {S}, {hd}) bf16 causal: {ms:.4f}"
          f" ms (plain {plain_ms:.4f} ms a batch row at a time; "
          f"scaled_dot_product_attention's backward {lib_ms:.4f} ms, its "
          f"forward + backward less its forward's {lib_fwd:.4f}; kernel / "
          f"library {ms / lib_ms:.2f}x; bound {b_ms:.4f} ms by {b_by} at "
          f"the bf16 tensor-core peak: {b_ms / ms:.1%} of it; "
          f"{flops / ms / 1e9:.1f} TFLOP/s of the function); the forward "
          f"with its lse {fwd_ms:.4f} ms")
    del q, k, v, do, o, lse, qg, kg, vg
    torch.cuda.empty_cache()
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": None, "launches": 0, "max_abs_err": worst,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


def phase_lm(seed: int, counters) -> int:
    """The port's ``Model`` on the card.  (a) qwen2-7b at full width and
    depth in bf16 from random weights: a forward with attn_impl='flash'
    on LM_BATCH x LM_SEQ tokens (the flash kernel's path, with every
    kernel's launch count reset just before it and read just after), the
    same forward with attn_impl='ref', and ``generate`` (prefill, then
    LM_NEW greedy decode steps); the gate is finite logits.  (b) The
    reference's tight gates at qwen2-7b's widths in fp32 with the depth
    cut to 4 layers: flash forward vs ref forward within 1e-4, prefill of
    K - 1 tokens and decode of token K vs the forward's logits within
    2e-3.  Returns the flash kernel's launches in (a)'s forward."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    full = dataclasses.replace(get_config(LM_ARCH), attn_impl="flash")
    model = Model(full)                       # cuda: sets the fp32 policy
    model_ref = Model(dataclasses.replace(full, attn_impl="ref"))
    policy = {"cuda.matmul.allow_tf32":
              torch.backends.cuda.matmul.allow_tf32,
              "cuda.matmul.allow_bf16_reduced_precision_reduction":
              torch.backends.cuda.matmul
              .allow_bf16_reduced_precision_reduction}
    print(f"[lm] precision policy as the port's Model set it: {policy}")
    if any(policy.values()):
        raise AssertionError("the Model did not set its precision policy")
    g = torch.Generator(device=dev).manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = model.init(g)
    torch.cuda.synchronize()
    n_params = model.param_count(params)
    print(f"[lm] {full.name}: {full.n_layers} layers, d_model "
          f"{full.d_model}, {full.n_heads}/{full.n_kv_heads} heads of "
          f"{full.resolved_head_dim}, d_ff {full.d_ff}, vocab "
          f"{full.vocab_size}, {full.dtype}: {n_params:,} params "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB), random init on "
          f"the card in {time.perf_counter() - t0:.2f} s")
    B, S = LM_BATCH, LM_SEQ
    tokens = torch.randint(0, full.vocab_size, (B, S), generator=g,
                           device=dev)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    timed(lambda: model.forward(params, tokens))          # warm-up
    reset_counters(counters)
    torch.cuda.reset_peak_memory_stats()
    (logits, _), fwd_ms = timed(lambda: model.forward(params, tokens))
    counts = {name: f.launches for name, f in counters.items()}
    routes = dict(fa.flash_attention_cuda.routes)
    peak = torch.cuda.max_memory_allocated()
    launches = counts["flash_attention"]
    if launches != full.n_layers or sum(counts.values()) != launches:
        raise AssertionError(f"the flash forward launched {counts}, not "
                             f"{full.n_layers} flash_attention")
    if routes != {"cuda_cores": 0, "tensor_cores": full.n_layers}:
        raise AssertionError(f"the bf16 flash forward's launches went to "
                             f"{routes}, not all to the tensor-core kernel")
    if logits.shape != (B, S, full.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("the flash forward's logits are not finite")
    (logits_r, _), ref_ms = timed(lambda: model_ref.forward(params, tokens))
    if not bool(torch.isfinite(logits_r).all()):
        raise AssertionError("the ref forward's logits are not finite")
    d = float((logits - logits_r).abs().max())
    top1 = float((logits.argmax(-1) == logits_r.argmax(-1)).float().mean())
    print(f"[lm] forward {B}x{S} tokens, attn_impl='flash': {fwd_ms:.1f} ms "
          f"(host clock, second call), {launches} flash_attention launches "
          f"(one a layer; routes {routes}), peak {peak / 1e9:.2f} GB; "
          f"attn_impl='ref': "
          f"{ref_ms:.1f} ms; bf16 flash vs ref: max|dlogits| {d:.3e}, "
          f"top-1 agreement {top1:.4%} (not gated at bf16)")
    del logits, logits_r
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    out, gen_ms = timed(lambda: model.generate(params, tokens, LM_NEW + 1))
    if out.shape != (B, LM_NEW + 1) or int(out.min()) < 0 or \
            int(out.max()) >= full.vocab_size:
        raise AssertionError(f"generate gave {tuple(out.shape)} tokens in "
                             f"[{int(out.min())}, {int(out.max())}]")
    (_, cache), pre_ms = timed(lambda: model.prefill(params, tokens,
                                                     max_len=S + LM_NEW + 1))
    tok = out[:, 0]

    def steps():
        t = tok
        for i in range(LM_NEW):
            lg, _ = model.decode(params, cache, t, S + i)
            t = lg.argmax(-1)
        return t

    _, dec_ms = timed(steps)
    peak = torch.cuda.max_memory_allocated()
    print(f"[lm] generate: prefill {B}x{S} + {LM_NEW} greedy decode steps "
          f"in {gen_ms:.1f} ms; prefill alone {pre_ms:.1f} ms, {LM_NEW} "
          f"decode steps {dec_ms:.1f} ms ({dec_ms / LM_NEW:.2f} ms a step, "
          f"{B * LM_NEW / dec_ms * 1e3:.1f} tok/s at batch {B}); peak "
          f"{peak / 1e9:.2f} GB; tokens of seq 0: {out[0].tolist()}")
    del out
    trace_device(lambda: model.forward(params, tokens),
                 f"{full.name} forward {B}x{S} tokens, attn_impl='flash'")
    trace_device(steps, f"{full.name} {LM_NEW} greedy decode steps at "
                        f"batch {B} after a {S}-token prefill")
    del params, cache
    torch.cuda.empty_cache()

    small = dataclasses.replace(full, n_layers=4, dtype="float32")
    model = Model(small)
    model_ref = Model(dataclasses.replace(small, attn_impl="ref"))
    params = model.init(g)
    print(f"[lm] tight gates: {small.name} widths, {small.n_layers} layers, "
          f"fp32: {model.param_count(params):,} params")
    fa.flash_attention_cuda.launches = 0
    fa.flash_attention_cuda.routes = dict.fromkeys(fa.ROUTES, 0)
    logits, _ = model.forward(params, tokens)
    logits_r, _ = model_ref.forward(params, tokens)
    d = float((logits - logits_r).abs().max())
    ok = torch.allclose(logits, logits_r, rtol=1e-4, atol=1e-4)
    print(f"[lm]   flash vs ref forward: max|dlogits| {d:.3e} (rtol = atol "
          f"= 1e-4), {fa.flash_attention_cuda.launches} flash launches "
          f"(routes {fa.flash_attention_cuda.routes})")
    if not ok:
        raise AssertionError("fp32 flash forward differs from ref")
    del logits_r
    K = S
    pre, cache = model.prefill(params, tokens[:, :K - 1], max_len=K + 4)
    dec, _ = model.decode(params, cache, tokens[:, K - 1], K - 1)
    for name, got, want in (("prefill", pre, logits[:, K - 2]),
                            ("decode", dec, logits[:, K - 1])):
        e = float((got - want).abs().max())
        print(f"[lm]   {name} vs forward logits: max|d| {e:.3e} (rtol = "
              f"atol = 2e-3)")
        if not torch.allclose(got, want, rtol=2e-3, atol=2e-3):
            raise AssertionError(f"fp32 {name} differs from the forward")
    del params, cache, logits
    torch.cuda.empty_cache()
    return launches


# -- phase 5b: the rest of the LM zoo ------------------------------------------

# (architecture, layers kept in the bf16 run (None: all), attn_impl of the
# counted forward, layers of the fp32 gates).  Full width throughout; the
# depth cuts keep the bf16 run's peak under ~70 GB of the card's 80:
# phi3.5-moe 2.62 GB a layer (all 32: 83.7 GB), deepseek-v2 its dense
# layer + 7 MoE layers of 7.94 GB.
ZOO = (("phi3.5-moe-42b-a6.6b", 25, "flash", 4),
       ("deepseek-v2-236b", 8, "flash", 2),
       ("mamba2-1.3b", None, "ref", 6),
       ("zamba2-2.7b", None, "flash", 6))


def expected_flash(cfg) -> int:
    """Flash launches of one forward: one a GQA attention layer (MLA has
    no flash branch), zamba2's shared block once a group."""
    if cfg.attn_impl != "flash" or cfg.mla or cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.hybrid_attn_every
    return cfg.n_layers


def with_expert_choices(fn, replay=None):
    """``fn()`` with ``moe._route`` wrapped; returns its result and, for
    each MoE layer's call, the ids and the router's gap between its k-th
    and (k+1)-th probability.  With ``replay`` (such a list from another
    run) each layer routes to the replayed ids instead, weighted by its
    own router probabilities at them, renormalised."""
    import torch
    from repro_torch.models import moe

    route, seen = moe._route, []

    def wrapped(cfg, p, xf):
        w, ids, aux = route(cfg, p, xf)
        probs = torch.softmax(xf.float() @ p["router"], dim=-1)
        top = torch.topk(probs, cfg.experts_per_token + 1, dim=-1).values
        if replay is not None:
            ids = replay[len(seen)][0]
            w = probs.gather(-1, ids)
            w = (w / w.sum(-1, keepdim=True)).to(xf.dtype)
        seen.append((ids, top[:, -2] - top[:, -1]))
        return w, ids, aux

    moe._route = wrapped
    try:
        out = fn()
    finally:
        moe._route = route
    return out, seen


def router_flips(model, ref_model, params, tokens) -> None:
    """Why bf16 flash and ref forwards of a MoE model disagree: the share
    of tokens whose expert set differs between the two, layer by layer;
    the router's top-k gap of the first flipped tokens against all
    tokens'; and the top-1 agreement of the flash forward with the ref
    forward's expert choices replayed in it."""
    import torch

    def top1(fn, replay=None):
        (logits, _), seen = with_expert_choices(fn, replay)
        return logits.argmax(-1), seen

    top_f, run_f = top1(lambda: model.forward(params, tokens))
    top_r, run_r = top1(lambda: ref_model.forward(params, tokens))
    top_p, _ = top1(lambda: model.forward(params, tokens), replay=run_r)
    flips = [(a.sort(-1).values != b.sort(-1).values).any(-1)
             for (a, _), (b, _) in zip(run_f, run_r)]
    share = [float(f.float().mean()) for f in flips]
    first = next((i for i, f in enumerate(flips) if bool(f.any())), None)
    agree = [float((x == top_r).float().mean()) for x in (top_f, top_p)]
    line = (f"[zoo]   router flips, bf16 flash vs ref: expert set differs "
            f"for {share[0]:.4%} of tokens at MoE layer 0, "
            f"{share[len(share) // 2]:.4%} at layer {len(share) // 2}, "
            f"{share[-1]:.4%} at layer {len(share) - 1}")
    if first is not None:
        gap = run_r[first][1]
        line += (f"; first flips at layer {first}: median top-k gap "
                 f"{float(gap[flips[first]].median()):.3e} over the "
                 f"{int(flips[first].sum())} flipped tokens, "
                 f"{float(gap.median()):.3e} over all")
    print(line + f"; top-1 agreement {agree[0]:.4%}, with the ref's expert "
          f"choices replayed in the flash forward {agree[1]:.4%}")


def time_expert_routes(cfg, params, seed: int) -> None:
    """The two routes of ``moe.expert_matmul`` at the model's shapes: the
    first MoE layer's router on LM_BATCH x LM_SEQ random activations
    gives the group sizes; ``grouped_mm`` (one launch) and the per-expert
    ``torch.matmul`` loop each run the layer's three GEMMs on the sorted
    rows, bf16.  The two routes' outputs agree within two bf16 ulps
    (``rtol = atol = 2**-6``; each rounds an fp32 sum once), then each is
    timed by CUDA events."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import moe

    p = {k: v[0] for k, v in params["decoder"]["layers"]["moe"].items()
         if k != "shared"}
    g = torch.Generator(device="cuda").manual_seed(seed + 11)
    T, k = LM_BATCH * LM_SEQ, cfg.experts_per_token
    xf = torch.randn(T, cfg.d_model, generator=g, device="cuda").bfloat16()
    _, ids, _ = moe._route(cfg, p, xf)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True)
    xs = xf[order // k]
    sizes = torch.bincount(flat, minlength=cfg.n_experts)
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    h = torch.randn(T * k, cfg.moe_d_ff, generator=g,
                    device="cuda").bfloat16()

    def lib():
        return [F.grouped_mm(xs, p["gate"], offs=offs),
                F.grouped_mm(xs, p["up"], offs=offs),
                F.grouped_mm(h, p["down"], offs=offs)]

    def loop(keep=False):
        outs, start = [[], [], []], 0
        for e, n in enumerate(sizes.tolist()):
            if n:
                parts = (xs[start:start + n] @ p["gate"][e],
                         xs[start:start + n] @ p["up"][e],
                         h[start:start + n] @ p["down"][e])
                if keep:
                    for o, part in zip(outs, parts):
                        o.append(part)
            start += n
        return [torch.cat(o) for o in outs] if keep else None

    worst = 0.0
    for name, got, want in zip(("gate", "up", "down"), lib(),
                               loop(keep=True)):
        worst = max(worst, float((got.float() - want.float()).abs().max()))
        if not torch.allclose(got.float(), want.float(), rtol=2 ** -6,
                              atol=2 ** -6):
            raise AssertionError(f"{cfg.name}: grouped_mm and the "
                                 f"per-expert loop disagree on {name}")
    print(f"[zoo]   grouped_mm vs per-expert loop, gate / up / down: "
          f"max|d| {worst:.3e} (rtol = atol = 2**-6)")
    lib_ms, loop_ms = cuda_ms(lib, iters=10), cuda_ms(loop, iters=10)
    lib_ms2, loop_ms2 = cuda_ms(lib, iters=10), cuda_ms(loop, iters=10)
    flops = 3 * 2 * T * k * cfg.d_model * cfg.moe_d_ff
    used = int((sizes > 0).sum())
    print(f"[zoo]   grouped GEMMs of one MoE layer ({T} tokens x top-{k} "
          f"over {cfg.n_experts} experts, {used} used, rows a used expert "
          f"{int(sizes.min())}-{int(sizes.max())}; d {cfg.d_model}, ff "
          f"{cfg.moe_d_ff}, bf16, {flops / 1e9:.1f} GFLOP): grouped_mm "
          f"{lib_ms:.4f} / {lib_ms2:.4f} ms, per-expert loop {loop_ms:.4f} / "
          f"{loop_ms2:.4f} ms (two turns each; the loop's host sync on the "
          f"group sizes excluded); grouped_mm at "
          f"{flops / min(lib_ms, lib_ms2) / 1e9:.1f} TFLOP/s")


def phase_zoo(seed: int, counters) -> int:
    """The zoo's other families on the card (``ZOO``), each in bf16 at full
    width from random weights, then freed: a LM_BATCH x LM_SEQ forward
    with every kernel's launch count reset just before it and read just
    after (flash: one a GQA layer, zamba2's shared block once a group, at
    head dim 80; none for MLA or mamba2; all on the tensor-core route),
    an attn_impl='ref' forward where the counted one took 'flash', and
    ``generate`` (prefill, then LM_NEW greedy decode steps), the forward
    and the decode steps traced; for the MoE archs the grouped-GEMM route
    counts and the two routes' times.  Then
    the reference's tight gates in fp32 at full width and the cut depth
    of ``ZOO``: flash vs ref forward within 1e-4, prefill of K - 1 tokens
    and decode of token K vs the forward within 2e-3, ragged vs dense MoE
    within 2e-4, chunked vs full MLA within 2e-3.  Returns the flash
    launches of the counted forwards."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    B, S = LM_BATCH, LM_SEQ
    total = 0

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def close(name, got, want, tol):
        e = float((got - want).abs().max())
        print(f"[zoo]     {name}: max|d| {e:.3e} (rtol = atol = {tol:.0e})")
        if not torch.allclose(got, want, rtol=tol, atol=tol):
            raise AssertionError(f"{name} beyond {tol}")

    for arch, depth, impl, gate_layers in ZOO:
        base = get_config(arch)
        full = dataclasses.replace(base, n_layers=depth or base.n_layers,
                                   attn_impl=impl)
        g = torch.Generator(device=dev).manual_seed(seed)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        model = Model(full)
        params, init_ms = timed(lambda: model.init(g))
        n_params = model.param_count(params)
        print(f"[zoo] {arch}: {full.n_layers} of {base.n_layers} layers, "
              f"d_model {full.d_model}, {full.dtype}, attn_impl "
              f"{full.attn_impl!r}: {n_params:,} params "
              f"({torch.cuda.memory_allocated() / 1e9:.2f} GB), init "
              f"{init_ms / 1e3:.2f} s, peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        tokens = torch.randint(0, full.vocab_size, (B, S), generator=g,
                               device=dev)
        timed(lambda: model.forward(params, tokens))          # warm-up
        reset_counters(counters)
        moe.expert_matmul.routes = dict.fromkeys(moe.ROUTES, 0)
        torch.cuda.reset_peak_memory_stats()
        (logits, aux), fwd_ms = timed(lambda: model.forward(params, tokens))
        counts = {name: f.launches for name, f in counters.items()}
        routes = dict(fa.flash_attention_cuda.routes)
        gemm_routes = dict(moe.expert_matmul.routes)
        peak = torch.cuda.max_memory_allocated()
        want = expected_flash(full)
        launches = counts["flash_attention"]
        if launches != want or sum(counts.values()) != launches or \
                routes != {"cuda_cores": 0, "tensor_cores": want}:
            raise AssertionError(f"{arch}'s forward launched {counts} "
                                 f"(flash routes {routes}), not {want} "
                                 "flash_attention on the tensor cores")
        if full.n_experts and gemm_routes != {
                "grouped_mm": 3 * (full.n_layers - full.first_dense_layers),
                "loop": 0}:
            raise AssertionError(f"{arch}'s bf16 MoE GEMMs went to "
                                 f"{gemm_routes}")
        if logits.shape != (B, S, full.vocab_size) or \
                not bool(torch.isfinite(logits).all()) or \
                not bool(torch.isfinite(aux)):
            raise AssertionError(f"{arch}'s forward is not finite")
        total += launches
        line = (f"[zoo]   forward {B}x{S} tokens: {fwd_ms:.1f} ms (host "
                f"clock, second call), {launches} flash_attention launches "
                f"(routes {routes}"
                + (f", head dim {full.resolved_head_dim} run at "
                   f"{fa.padded_head_dim(full.resolved_head_dim)}"
                   if launches else "") + f"), peak {peak / 1e9:.2f} GB")
        if full.n_experts:
            line += f"; grouped GEMM launches {gemm_routes}, aux {float(aux):.4f}"
        print(line)
        if impl == "flash" and launches:
            ref_model = Model(dataclasses.replace(full, attn_impl="ref"))
            (logits_r, _), ref_ms = timed(
                lambda: ref_model.forward(params, tokens))
            d = float((logits - logits_r).abs().max())
            top1 = float((logits.argmax(-1) == logits_r.argmax(-1))
                         .float().mean())
            print(f"[zoo]   attn_impl='ref' forward: {ref_ms:.1f} ms; bf16 "
                  f"flash vs ref: max|dlogits| {d:.3e}, top-1 agreement "
                  f"{top1:.4%} (not gated at bf16)")
            del logits_r
        del logits
        if impl == "flash" and launches and full.n_experts:
            router_flips(model, ref_model, params, tokens)
        if full.n_experts:
            time_expert_routes(full, params, seed)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out, gen_ms = timed(lambda: model.generate(params, tokens,
                                                   LM_NEW + 1))
        if out.shape != (B, LM_NEW + 1) or int(out.min()) < 0 or \
                int(out.max()) >= full.vocab_size:
            raise AssertionError(f"{arch}: generate gave "
                                 f"{tuple(out.shape)} tokens")
        (_, cache), pre_ms = timed(lambda: model.prefill(
            params, tokens, max_len=S + LM_NEW + 1))

        def steps():
            t = out[:, 0]
            for i in range(LM_NEW):
                lg, _ = model.decode(params, cache, t, S + i)
                t = lg.argmax(-1)
            return t

        _, dec_ms = timed(steps)
        print(f"[zoo]   generate: prefill {B}x{S} + {LM_NEW} greedy decode "
              f"steps in {gen_ms:.1f} ms; prefill alone {pre_ms:.1f} ms, "
              f"{LM_NEW} decode steps {dec_ms:.1f} ms ({dec_ms / LM_NEW:.2f} "
              f"ms a step, {B * LM_NEW / dec_ms * 1e3:.1f} tok/s at batch "
              f"{B}); peak {torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"GB; tokens of seq 0: {out[0].tolist()}")
        trace_device(lambda: model.forward(params, tokens),
                     f"{arch} forward {B}x{S} tokens, attn_impl={impl!r}",
                     top=8)
        trace_device(steps, f"{arch} {LM_NEW} greedy decode steps at batch "
                            f"{B} after a {S}-token prefill", top=8)
        del params, cache, out, model
        torch.cuda.empty_cache()

        # the tight gates: fp32, full width, gate_layers deep
        small = dataclasses.replace(base, n_layers=gate_layers,
                                    dtype="float32", attn_impl=impl)
        model = Model(small)
        model_ref = Model(dataclasses.replace(small, attn_impl="ref"))
        params = model.init(g)
        print(f"[zoo]   tight gates: {small.n_layers} layers, fp32: "
              f"{model.param_count(params):,} params")
        fa.flash_attention_cuda.launches = 0
        fa.flash_attention_cuda.routes = dict.fromkeys(fa.ROUTES, 0)
        logits, _ = model.forward(params, tokens)
        if expected_flash(small):
            logits_r, _ = model_ref.forward(params, tokens)
            print(f"[zoo]     {fa.flash_attention_cuda.launches} flash "
                  f"launches (routes {fa.flash_attention_cuda.routes})")
            if fa.flash_attention_cuda.launches != expected_flash(small):
                raise AssertionError("the fp32 flash forward's launches")
            close("flash vs ref forward logits", logits, logits_r, 1e-4)
            del logits_r
        pre, cache = model.prefill(params, tokens[:, :S - 1],
                                   max_len=S + 4)
        dec, _ = model.decode(params, cache, tokens[:, S - 1], S - 1)
        close("prefill vs forward logits", pre, logits[:, S - 2], 2e-3)
        close("decode vs forward logits", dec, logits[:, S - 1], 2e-3)
        del cache, logits
        if small.mla:
            half = tokens[:, :S // 2]
            want, _ = model_ref.forward(params, half)
            got, _ = Model(dataclasses.replace(
                small, attn_impl="chunked")).forward(params, half)
            close(f"chunked (attn_chunk {small.attn_chunk}) vs full MLA "
                  f"logits, {B}x{S // 2} tokens", got, want, 2e-3)
            del got, want
        if small.n_experts:
            # the dense oracle holds (E, T, d) fp32: half the tokens
            half = tokens[:, :S // 2]
            want, aux_d = Model(dataclasses.replace(
                small, moe_impl="dense")).forward(params, half)
            got, aux_r = model_ref.forward(params, half)
            close(f"ragged vs dense MoE logits, {B}x{S // 2} tokens", got,
                  want, 2e-4)
            close("ragged vs dense MoE aux", aux_r, aux_d, 2e-4)
            del got, want
        del params, model, model_ref
        torch.cuda.empty_cache()
    return total


# -- phase 5b: federated LM training, one host and the mesh -------------------

# stablelm-1.6b at its published widths (src/repro/configs/stablelm_1_6b.py,
# hf: stabilityai/stablelm-2-1_6b), trained as the reference's example
# does: n = 4 clients in c = 2 clusters, T = 5 (launch/shapes.py
# DEFAULT_T), one sequence of train_4k's 4,096 tokens a client a step
LMT_ARCH, LMT_N, LMT_C, LMT_T, LMT_B, LMT_S = "stablelm-1.6b", 4, 2, 5, 1, 4096
LMT_ROUNDS, LMT_LOSS_CHUNK, LMT_ETA = 2, 1024, 0.05
# the fp32 pins at full width and 2 layers, and the mesh phase, take
# sequences of 1,024 tokens: the width is the test, the length only time
LMT_PIN_LAYERS, LMT_PIN_S, MESH_S = 2, 1024, 1024
# [lmtrain] and [mesh] run 6 of the 24 layers (the widths unchanged) so
# that the script, grown by [tp]'s archs, keeps to its time; [tp] trains
# all 24
LMT_LAYERS = MESH_LAYERS = 6
# [moetrain]: phi3.5-moe at its published widths (src/repro/configs/
# phi35_moe_42b.py, hf: microsoft/Phi-3.5-MoE-instruct) on [lmtrain]'s
# recipe (n, c, T, rounds, remat, chunked attention, loss chunk, tokens),
# at the depth 80 GB allows: one of its 32 layers is 1.56e9 values a
# client, a (4, 1.56e9) bf16 payload, about [lmtrain]'s at 24 layers
# (73.2 GB peak with record_mixed on an H100), and under vmap the MoE runs
# the dense oracle (every expert on every token): at [lmtrain]'s 4,096 tokens
# a client a step the phase alone peaks at 75.9 GB of the card's 85.0 (since
# the engine frees each round's mixed deltas before the next), which leaves
# too little for what the whole script may hold beside it, so MOET_S is cut
# to 2,048 (every run peaks at 58.5 GB or under there).  Its fp32 pins take
# the fewest clients and tokens.
MOET_ARCH, MOET_LAYERS, MOET_S = "phi3.5-moe-42b-a6.6b", 1, 2048
MOET_PIN_N, MOET_PIN_S = 2, 256
# [zootrain]: [lmtrain]'s recipe (n, c, T, rounds, remat, chunked
# attention, the loss chunk, LMT_S tokens a client a step) on the SSD
# families at their published widths: mamba2-1.3b (src/repro/configs/
# mamba2_1_3b.py, arXiv:2405.21060) and zamba2-2.7b (zamba2_2_7b.py,
# arXiv:2411.15242), each cut in whole layers (zamba2: whole groups of
# hybrid_attn_every Mamba blocks and the shared attention block, at
# least two, so that the shared block's gradient comes from two call
# sites) by two rules: a round peaks near ZOOT_TREES bf16 trees of the
# params ([moetrain] on an H100: 58.50 GB at a 3.13 GB tree) plus the
# activations, and must stay under ZOOT_PEAK_GB (>= 20 GB spare, as MOET_S
# was cut for: zamba2 whole, 4.85 GB a tree, cannot run); and the phase
# keeps to ZOOT_BUDGET_S of the script's time.  The SSD keeps dt_bias,
# A_log and D in fp32: a second dtype group, one more launch of each
# kernel a round.  (arch, layers, tokens a client a step, fp32 pin
# layers, why the cut); the pins take ZOOT_PIN_N clients of ZOOT_PIN_S
# tokens
ZOOT_TREES, ZOOT_PEAK_GB, ZOOT_BUDGET_S = 18.7, 60, 150
ZOOT_ARCHS = (
    ("mamba2-1.3b", 16, LMT_S, 2,
     "the phase's time: a phase runs 7 rounds, which take 19.2 s whole "
     "and 9.95 s at 24 layers on an H100 (the phase then took 155.4 s)"),
    ("zamba2-2.7b", 12, 2048, 12,
     "the card's memory: zamba2's remat unit is a group (6 Mamba blocks "
     "and the shared block), whose activations for 4 clients under vmap "
     "peaked at 81.76 GB at 12 layers and 4,096 tokens on an H100 (48.65 "
     "GB at 2,048); two groups, the fewest that give the shared block two "
     "call sites"))
ZOOT_PIN_N, ZOOT_PIN_S = 2, 256
# bf16 runs against each other are held by their change from the init
# params, d = params - init, in norm: ||d - d_einsum|| / ||d_einsum||
# (most bf16 steps round away, so the params themselves differ little
# whatever the D2S update did; a dropped update gives 1).  After round 0
# the backends have started from the same params with the same local
# SGD: 'einsum' rounds the mixed deltas to bf16 before the D2S sum and
# the one-pass kernels do not, so only a rare final add rounds to the
# other neighbour (CHANGE_REL[0]; 2.7e-4 on an H100, 0.011% of values).
# Each such value changes the next round's gradients everywhere, so
# after the last round the runs have drifted apart further
# (CHANGE_REL[1]; 0.17 on an H100, 0.92% of values): that gate only
# says the change is mostly einsum's.  The mesh at n = 1 is the same
# computation as LocalEngine's but for vmap (bitwise on an H100), held
# at CHANGE_REL[0].  einsum must move at least MOVED_MIN of the values
# (5.7% after round 0 on an H100), or the gates see too little.
CHANGE_REL, MOVED_MIN = (0.01, 0.5), 0.01
# the kernels at the LM payload against their plain versions: the fp32
# row within AGG_REL of sum_i |w_i X_i|, the bf16 mixed output within
# one bf16 ulp of each value
AGG_REL, MIXED_ULPS = 1e-5, 1
ORACLE_F32 = dict(rtol=2e-4, atol=2e-5)


def lm_train_config(arch: str = LMT_ARCH, **changes):
    """``arch`` (stablelm-1.6b by default) at its published widths with
    the training settings: per-layer remat, query-chunked attention (the
    flash kernels on the card in bf16), sequence-chunked head and loss;
    ``changes`` (depth, dtype) on top."""
    import dataclasses
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(arch), remat=True,
                               attn_impl="chunked",
                               loss_chunk=LMT_LOSS_CHUNK, **changes)


def lm_train_data(cfg, seed: int, S: int, n: int = LMT_N):
    """A token stream from the seed (``make_token_stream``) and a sampler
    drawing each round's (x, y) batches (``lm_batches``, CPU int32, (n,
    T, B, S))."""
    from repro_torch.data import lm_batches, make_token_stream
    stream = make_token_stream(n_tokens=max(1 << 15, 4 * n * (S + 2)),
                               vocab=cfg.vocab_size, seed=seed)
    return lambda rng, t: lm_batches(stream, rng, n, LMT_T, LMT_B, S)


def _lm_server(cfg, params, sampler, seed, n=LMT_N, **execution):
    """A ``FederatedServer`` on a ``k_regular`` network of ``n`` clients
    in n / 2 clusters (LMT_C at LMT_N)."""
    from repro_torch import topology
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.fl.engine import ExecutionConfig
    network = topology.make_spec("k_regular", n=n, c=max(n // 2, 1),
                                 k_range=(1, 2), p_fail=0.0).build()
    scfg = ServerConfig(T=LMT_T, t_max=LMT_ROUNDS, phi_max=1.0,
                        bound_kind="regular", seed=seed,
                        eta=lambda t: LMT_ETA)
    return FederatedServer(network, None, params, sampler, scfg,
                           execution=ExecutionConfig(model_cfg=cfg,
                                                     **execution))


def _ulp_of(v):
    """One bf16 ulp at each value of the fp32 tensor ``v`` (2^-133 below
    the least normal, so a zero admits no other value)."""
    import torch
    _, e = torch.frexp(v.abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(v), e - 8)


def _change_sums(got, want, init, device, counted=None):
    """``_change_stats``' running sums over the leaves of ``got``, ``want``
    and ``init`` (each leaf moved to ``device`` and read a column chunk
    at a time, so a GB leaf needs no GBs of temporaries), the leaves where
    ``counted`` (a list of bools, default all) is false left out: [num,
    den, moved, sum_ulps, differ, total] to add up and [max_moved,
    max_ulps] to take the largest of, across trees or ranks."""
    import torch
    from repro_torch.core.pytree import tree_flatten
    sums, maxes = [0.0] * 6, [0.0, 0.0]
    chunk = 1 << 27
    leaves = zip(tree_flatten(got)[0], tree_flatten(want)[0],
                 tree_flatten(init)[0])
    for k, (a, b, i) in enumerate(leaves):
        if counted is not None and not counted[k]:
            continue
        a, b, i = (x.to(device).reshape(-1) for x in (a, b, i))
        for c in range(0, a.numel(), chunk):
            a32, b32, i32 = (x[c:c + chunk].float() for x in (a, b, i))
            if not torch.isfinite(a32).all():
                raise AssertionError("non-finite params")
            dw = b32 - i32
            on = dw != 0
            moved_ulps = dw.abs()[on] / _ulp_of(
                torch.maximum(i32.abs(), b32.abs())[on])
            mag = torch.maximum(torch.maximum(a32.abs(), b32.abs()),
                                i32.abs())
            sums[0] += float((a32 - b32).double().square().sum())
            sums[1] += float(dw.double().square().sum())
            sums[2] += int(on.sum())
            sums[3] += float(moved_ulps.double().sum())
            sums[4] += int((a32 != b32).sum())
            sums[5] += a32.numel()
            if moved_ulps.numel():
                maxes[0] = max(maxes[0], float(moved_ulps.max()))
            maxes[1] = max(maxes[1], float(((a32 - b32).abs()
                                            / _ulp_of(mag)).max()))
            del a32, b32, i32, dw, on, moved_ulps, mag
        del a, b, i
    return sums, maxes


def _change_finish(sums, maxes):
    """The ``_change_stats`` dict from ``_change_sums``' totals."""
    num, den, moved, sum_ulps, differ, total = sums
    return dict(rel=(num / den) ** 0.5 if den else float(num > 0) * 1e9,
                moved=moved / total,
                moved_ulps=sum_ulps / moved if moved else 0.0,
                max_moved_ulps=maxes[0], differ=differ / total,
                max_ulps=maxes[1])


def _change_stats(got, want, init, device):
    """Two bf16 runs from the same ``init`` (trees; a leaf of ``want`` may
    lie on the host, and is moved to ``device`` one leaf at a time): the
    change ``got - init`` against ``want - init``.  Returns ``rel``
    ||dgot - dwant|| / ||dwant|| over all values, ``moved`` the share of
    values ``want`` moved, ``moved_ulps`` the mean and ``max_moved_ulps``
    the largest |dwant| there in bf16 ulps of max(|init|, |want|),
    ``differ``
    the share of values where got != want, and ``max_ulps`` the largest
    |got - want| in bf16 ulps of max(|got|, |want|, |init|) (a sum that
    cancels rounds at its operands' ulp, not at its result's)."""
    return _change_finish(*_change_sums(got, want, init, device))


def _small_group_check(tag, A, w, X) -> None:
    """Both kernels on a small fp32 dtype group of a training payload (X
    (n, p): an MoE's router, the SSD's dt_bias / A_log / D) against their
    plain versions, untimed: the fp32 rows, and each mixed value, within
    AGG_REL of the sum of its products' magnitudes (fp32 sums of n
    products in another order)."""
    import torch
    from repro_torch.kernels.mixing import fused, ref

    if X.dtype != torch.float32:
        raise AssertionError(f"{tag} a small {X.dtype} group: only fp32 "
                             "ones are expected")
    Xa = X.abs()
    mixed, agg = fused.mix_aggregate_cuda(A, w, X)
    want_m, want_a = ref.mix_aggregate_ref(A, w, X)
    errs = {"aggregate": (fused.aggregate_cuda(w, X) - want_a,
                          w.abs() @ Xa),
            "mix_aggregate/agg": (agg - want_a, w.abs() @ Xa),
            "mix_aggregate/mixed": (mixed - want_m, A.abs() @ Xa)}
    print(f"{tag} the float32 group {tuple(X.shape)} vs the plain "
          f"versions: max|err| "
          + ", ".join(f"{k} {float(e.abs().max()):.3e}"
                      for k, (e, _) in errs.items())
          + f" (gate {AGG_REL:.0e} of the sum of |products|)")
    for k, (e, scale) in errs.items():
        if bool((e.abs() > AGG_REL * scale).any()):
            raise AssertionError(f"{tag} {k} on the float32 group: off by "
                                 f"more than {AGG_REL:.0e} of the sum of "
                                 "|products|")


def _leaves_close(name, got, want, tol):
    """Every leaf finite and allclose within ``tol``; returns max |got -
    want| and the share of values that differ."""
    import torch
    from repro_torch.core.pytree import tree_flatten
    worst, off, total = 0.0, 0, 0
    for a, b in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
        a32, b32 = a.float(), b.float()
        if not torch.isfinite(a32).all():
            raise AssertionError(f"{name}: non-finite params")
        d = float((a32 - b32).abs().max())
        if not torch.allclose(a32, b32, **tol):
            raise AssertionError(
                f"{name}: params differ by {d:.3e}, beyond rtol "
                f"{tol['rtol']:.2e} / atol {tol['atol']:.1e}")
        worst = max(worst, d)
        off += int((a32 != b32).sum())
        total += a32.numel()
    return worst, off / total


def _bitwise(name, a, b):
    import torch
    from repro_torch.core.pytree import tree_flatten
    if not all(torch.equal(x, y) for x, y in zip(tree_flatten(a)[0],
                                                  tree_flatten(b)[0])):
        raise AssertionError(f"{name}: not bitwise equal")


def phase_lmtrain(seed: int, counters, keep=None, arch: str = LMT_ARCH,
                  layers: int = LMT_LAYERS, S: int = LMT_S,
                  pin_layers: int = LMT_PIN_LAYERS, pin_n: int = LMT_N,
                  pin_s: int = LMT_PIN_S, extras: bool = True,
                  tag: str = "[lmtrain]", max_peak_gb=None):
    """Federated training of ``arch`` (stablelm-1.6b; [moetrain]:
    phi3.5-moe; [zootrain]: mamba2, zamba2) through Algorithm 1 on one
    card.  (a) bf16 at full width and ``layers`` layers, LMT_N clients of
    ``S`` tokens a step: 2 rounds on
    'einsum', on 'fused' (-> aggregate) and on 'fused' with record_mixed (->
    mix_aggregate) through ``FederatedServer`` with ``model_cfg``, the
    launch counts reset before each and read after; round ms, tokens/s,
    peak GB; the kernel backends' change from init against einsum's
    (``_change_stats``) after round 0 and after the last.  (b) one
    'aggregate' round timed by CUDA events in its two calls (local SGD's
    share), and the two kernels on its payload's largest dtype group
    (packed deltas, (4, ~1.645e9) bf16 for stablelm) against their plain
    versions computed in column chunks, timed beside the plain versions,
    their byte bounds and ``torch.matmul``, and on every other group (an
    fp32 one) against the plain versions (``_small_group_check``);
    ``moe.expert_matmul.routes`` unchanged by (a) and (b) (under vmap the
    MoE runs the dense oracle).  (c) one traced
    'aggregate' round (with ``extras``).  (d) fp32 pins at full width,
    ``pin_layers`` layers, ``pin_n`` clients of ``pin_s`` tokens: the
    kernel backends within rtol 2e-4 / atol 2e-5 of einsum, scanned ==
    sequential bitwise, and with ``extras`` all-ones active == None and
    remat on == off, bitwise.  Each run of (a) fails past ``max_peak_gb``
    where given.  Returns ``({kernel: launches in (a)},
    {kernel: row fields at this payload})``; ``keep`` (a dict), if given,
    gets the 'aggregate' run's trained params under "params"."""
    import dataclasses
    import gc
    import numpy as np
    import torch
    from repro_torch.core.pytree import tree_map
    from repro_torch.core.rounds import (_mix_and_update, client_deltas,
                                         make_round_fn)
    from repro_torch.fl import packing
    from repro_torch.kernels.mixing import ref
    from repro_torch.kernels.mixing.ops import combine_weights
    from repro_torch.models import moe
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    cfg = lm_train_config(arch, n_layers=layers)
    model = Model(cfg)
    # what earlier phases left in reference cycles is freed now, not when
    # the collector next happens to run
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    n_params = model.param_count(params)
    sampler = lm_train_data(cfg, seed, S)
    tokens = LMT_N * LMT_T * LMT_B * S
    expert_routes = dict(moe.expert_matmul.routes)
    # one launch a round per dtype group (an MoE's fp32 router is one)
    groups = packing.pack_spec(params).n_groups
    print(f"{tag} {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, "
          + (f"{cfg.n_heads} heads, d_ff {cfg.d_ff}, " if cfg.n_heads
             else "")
          + f"vocab {cfg.vocab_size}"
          + (f", {cfg.n_experts} experts top-{cfg.experts_per_token}, "
             f"moe_d_ff {cfg.moe_d_ff} (the dense oracle under vmap)"
             if cfg.n_experts else "")
          + (f", SSD state {cfg.ssm_state}, head dim {cfg.ssm_head_dim}, "
             f"expand {cfg.ssm_expand}, chunk {cfg.ssm_chunk}"
             if cfg.ssm_state else "")
          + f", {cfg.dtype}, {n_params:,} params "
          f"({n_params * 2 / 1e9:.2f} GB); remat {cfg.remat}, attn "
          f"{cfg.attn_impl}, loss_chunk {cfg.loss_chunk}; n {LMT_N}, c "
          f"{LMT_C}, T {LMT_T}, B {LMT_B}, S {S}: {tokens:,} tokens a "
          f"round, {LMT_ROUNDS} rounds a run; {held:.2f} GB allocated "
          "before the init")

    def run(backend, record_mixed=False, **kw):
        starts, ends, first = [], [], []

        def eval_fn(p):
            torch.cuda.synchronize()
            ends.append(time.perf_counter())
            if not first:          # round 0's params to the host, unclocked
                first.append(tree_map(lambda x: x.to("cpu"), p))
            starts.append(time.perf_counter())
            return {}

        server = _lm_server(cfg, params, sampler, seed, backend=backend,
                            record_mixed=record_mixed, **kw)
        reset_counters(counters)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        starts.append(time.perf_counter())
        hist = server.run(eval_fn=eval_fn)
        ms = [(b - a) * 1e3 for a, b in zip(starts, ends)]
        counts = {k: f.launches for k, f in counters.items() if f.launches}
        routes = {k: dict(f.routes) for k, f in counters.items()
                  if f.launches and hasattr(f, "routes")}
        peak = torch.cuda.max_memory_allocated() / 1e9
        if max_peak_gb is not None and peak > max_peak_gb:
            raise AssertionError(f"{tag} {cfg.name} on {backend}: peak "
                                 f"{peak:.2f} GB, over {max_peak_gb} GB")
        return server, hist, ms, counts, routes, peak, first[0]

    def cols(h):
        return [(r.t, r.m, r.m_actual, r.d2s, r.d2d, r.psi_bound, r.eta)
                for r in h.records]

    # local SGD's attention in every run (bf16 on the card: the flash
    # kernels, forward and backward)
    flash = flash_launches(cfg, LMT_ROUNDS * LMT_T)
    ref_server, ref_hist, ms, counts, _, peak, ref_first = run("einsum")
    if counts != flash:
        raise AssertionError(f"einsum launched kernels {counts}, not the "
                             f"flash kernels' {flash}")
    print(f"{tag} einsum: round ms {[round(x, 1) for x in ms]}, "
          f"{tokens / (ms[-1] / 1e3):,.0f} tokens/s (round 1), peak "
          f"{peak:.2f} GB; m(t) {[r.m_actual for r in ref_hist.records]}")
    launches, rows, round_ms = dict(flash), {}, {}
    for backend, record_mixed, effective, kernel in (
            ("fused", False, "aggregate", "aggregate"),
            ("fused", True, "fused", "mix_aggregate")):
        server, hist, ms, counts, routes, peak, first = run(backend,
                                                           record_mixed)
        if server.effective_backend != effective:
            raise AssertionError(f"{backend} dispatched "
                                 f"{server.effective_backend}")
        want = {kernel: LMT_ROUNDS * groups, **flash}
        if counts != want:
            raise AssertionError(f"{effective}: launches {counts}, not "
                                 f"{want}")
        if kernel in routes and routes[kernel] != {
                "generic": 0, "staged": LMT_ROUNDS * groups}:
            raise AssertionError(f"{kernel}: routes {routes[kernel]}")
        if cols(hist) != cols(ref_hist):
            raise AssertionError(f"{effective}: History differs from einsum")
        # the change from init on this backend against einsum's: after
        # round 0 (same start, same local SGD) and after the last round
        r0 = _change_stats(first, ref_first, params, dev)
        r1 = _change_stats(server.params, ref_server.params, params, dev)
        del first
        launches[kernel] = counts[kernel]
        for k in flash:
            launches[k] += counts[k]
        round_ms[effective] = ms[-1]
        if keep is not None and kernel == "aggregate":
            keep["params"] = server.params
        print(f"{tag} {backend} record_mixed={record_mixed} -> "
              f"{effective}: {counts[kernel]} {kernel} launches"
              + (f" (routes {routes[kernel]})" if kernel in routes else "")
              + "".join(f", {counts[k]} {k}" for k in flash)
              + f", round ms {[round(x, 1) for x in ms]}, "
              f"{tokens / (ms[-1] / 1e3):,.0f} tokens/s, peak {peak:.2f} "
              f"GB")
        for t, r in ((0, r0), (LMT_ROUNDS - 1, r1)):
            print(f"{tag}   after round {t}: einsum moved "
                  f"{r['moved']:.3%} of values from init, by "
                  f"{r['moved_ulps']:.2f} bf16 ulps on average (max "
                  f"{r['max_moved_ulps']:.1f}); {effective}'s change vs "
                  f"einsum's: ||d - d_einsum|| / ||d_einsum|| "
                  f"{r['rel']:.4e} (gate {CHANGE_REL[t > 0]}), "
                  f"{r['differ']:.4%} of values differ, by at most "
                  f"{r['max_ulps']:.2f} bf16 ulps of the value")
        if r0["moved"] < MOVED_MIN or r1["moved"] < MOVED_MIN:
            raise AssertionError(
                f"einsum moved {r0['moved']:.3%} / {r1['moved']:.3%} of "
                f"values, under {MOVED_MIN:.0%}: the gates below see "
                "too little")
        if r0["rel"] > CHANGE_REL[0] or r1["rel"] > CHANGE_REL[1]:
            raise AssertionError(f"{effective} vs einsum (bf16): change "
                                 f"off by {r0['rel']:.3e} / {r1['rel']:.3e}")
        del server, hist
        torch.cuda.empty_cache()
    del ref_server, ref_first
    torch.cuda.empty_cache()

    # (b) one 'aggregate' round timed by CUDA events in the two calls
    # make_round_fn's round makes (local SGD, then pack + aggregate +
    # apply), so local SGD's share is of that one round; then both
    # kernels on that round's payload
    batch = tuple(b.to(dev) for b in sampler(np.random.default_rng(seed),
                                             0))
    eta = torch.tensor(LMT_ETA, device=dev)
    A = torch.tensor([[.5, .5, 0, 0], [.5, .5, 0, 0], [0, 0, .5, .5],
                      [0, 0, .5, .5]], device=dev)
    tau = torch.tensor([1., 0., 1., 1.], device=dev)
    m3 = torch.tensor(3., device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    torch.cuda.synchronize()
    ev[0].record()
    deltas = client_deltas(model.loss, params, batch, eta)
    ev[1].record()
    new, _ = _mix_and_update(params, deltas, A, tau, m3,
                             mixing_backend="aggregate")
    ev[2].record()
    torch.cuda.synchronize()
    sgd_ms, rest_ms = ev[0].elapsed_time(ev[1]), ev[1].elapsed_time(ev[2])
    del new
    spec = packing.pack_spec(deltas)
    bufs = list(packing.pack(deltas, spec))
    del deltas
    # the largest group (the bf16 weights) is checked and timed below;
    # the others (an MoE's fp32 router, the SSD's fp32 dt_bias / A_log /
    # D) are held against the plain versions here
    big = max(range(len(bufs)), key=lambda g: bufs[g].numel())
    w = combine_weights(A, tau, m3).contiguous()
    for g, Xg in enumerate(bufs):
        if g != big:
            _small_group_check(tag, A, w, Xg)
    X = bufs[big]
    del bufs
    torch.cuda.empty_cache()
    n, p = X.shape
    chunk = 1 << 27
    nonzero = sum(int((X[:, c:c + chunk] != 0).sum())
                  for c in range(0, p, chunk))
    x_max = max(float(X[:, c:c + chunk].abs().max())
                for c in range(0, p, chunk))
    print(f"{tag} one 'aggregate' round, CUDA events: "
          f"{sgd_ms + rest_ms:.1f} ms, local SGD (client_deltas, {LMT_N} "
          f"clients x {LMT_T} steps, vmap(grad)) {sgd_ms:.1f} ms = "
          f"{sgd_ms / (sgd_ms + rest_ms):.2%} of it, pack + aggregate + "
          f"apply {rest_ms:.1f} ms; its payload X {tuple(X.shape)} "
          f"{str(X.dtype).split('.')[1]}, {X.numel() * 2 / 1e9:.2f} GB, "
          f"{spec.n_groups} dtype group(s): {nonzero / X.numel():.3%} of "
          f"values nonzero, max|X| {x_max:.3e}")
    absw = w.abs()
    f32, bf = 4, 2

    def plain_aggregate():
        return torch.cat([ref.aggregate_ref(w, X[:, c:c + chunk])
                          for c in range(0, p, chunk)])

    def plain_mix_aggregate():
        parts = [ref.mix_aggregate_ref(A, w, X[:, c:c + chunk])
                 for c in range(0, p, chunk)]
        return (torch.cat([m for m, _ in parts], dim=1),
                torch.cat([a for _, a in parts]))

    def agg_err(name, got, want, c):
        """max |got - want| on columns c+ of the fp32 row, absolute and
        over sum_i |w_i X_i| (fp32 sums of n = 4 products in two orders
        differ by a few 2^-24 of it; AGG_REL allows 2^7 of those, and
        where that sum is 0 both must be 0)."""
        scale = absw @ X[:, c:c + chunk].float().abs()
        err = (got - want).abs()
        if bool((err > AGG_REL * scale).any()):
            raise AssertionError(f"{name} at the LM payload, columns {c}+: "
                                 f"agg off by more than {AGG_REL:.0e} of "
                                 f"sum |w_i X_i| (max |err| "
                                 f"{float(err.max()):.3e})")
        return (float(err.max()),
                float((err / scale.clamp_min(2.0 ** -126)).max()))

    from repro_torch.kernels.mixing import fused
    got = fused.aggregate_cuda(w, X)
    e_agg = r_agg = 0.0
    for c in range(0, p, chunk):
        e, r = agg_err("aggregate", got[c:c + chunk],
                       ref.aggregate_ref(w, X[:, c:c + chunk]), c)
        e_agg, r_agg = max(e_agg, e), max(r_agg, r)
    del got
    ms_k = cuda_ms(lambda: fused.aggregate_cuda(w, X), iters=10)
    ms_p = cuda_ms(plain_aggregate, iters=2, warmup=1)
    wb = w.to(torch.bfloat16)
    ms_l = cuda_ms(lambda: torch.matmul(wb, X), iters=10)
    b_ms, b_by = bound(n * p * bf + n * f32 + p * f32, 2 * n * p)
    rows["aggregate"] = dict(ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
                             bound_ms=b_ms, bound_by=b_by, max_abs_err=e_agg)
    print(f"{tag} aggregate @ LM payload ({n}, {p}) bf16, G "
          f"{fused.aggregate_row_groups(X)}: {ms_k:.4f} ms (plain, in "
          f"column chunks, {ms_p:.4f} ms, torch.matmul in bf16 "
          f"{ms_l:.4f} ms, bound {b_ms:.4f} ms by {b_by}: {b_ms / ms_k:.1%}"
          f" of it; max|err| {e_agg:.3e}, at most {r_agg:.3e} of "
          f"sum |w_i X_i| (gate {AGG_REL:.0e}))")
    (mixed, agg), route = routed(fused.mix_aggregate_cuda, A, w, X)
    # against the plain version a column chunk at a time (an fp32 copy
    # of the whole mixed payload would be 26 GB).  mixed: both round the
    # fp32 A @ X to bf16, so they may differ by one bf16 ulp of the value
    # where the two fp32 sums round to either side of a midpoint, and a
    # zero must stay zero
    e_mix = e_ma = r_ma = u_mix = m_max = 0.0
    same = 0
    for c in range(0, p, chunk):
        want_m, want_a = ref.mix_aggregate_ref(A, w, X[:, c:c + chunk])
        got_m, want_m = mixed[:, c:c + chunk].float(), want_m.float()
        d = (got_m - want_m).abs()
        e_mix = max(e_mix, float(d.max()))
        u_mix = max(u_mix, float((d / _ulp_of(want_m)).max()))
        m_max = max(m_max, float(want_m.abs().max()))
        same += int((d == 0).sum())
        if u_mix > MIXED_ULPS:
            raise AssertionError(f"mix_aggregate at the LM payload, columns "
                                 f"{c}+: mixed off by {u_mix:.2f} bf16 ulps "
                                 f"of the value (max |err| {e_mix:.3e})")
        e, r = agg_err("mix_aggregate", agg[c:c + chunk], want_a, c)
        e_ma, r_ma = max(e_ma, e), max(r_ma, r)
        del want_m, want_a, got_m, d
    del mixed, agg
    torch.cuda.empty_cache()
    ms_k = cuda_ms(lambda: fused.mix_aggregate_cuda(A, w, X), iters=5)
    ms_p = cuda_ms(plain_mix_aggregate, iters=1, warmup=1)
    Bb = torch.cat([A, w[None]]).to(torch.bfloat16)
    ms_l = cuda_ms(lambda: torch.matmul(Bb, X), iters=5)
    b_ms, b_by = bound(2 * n * p * bf + p * f32 + (n + 1) * n * f32,
                       2 * (n + 1) * n * p)
    rows["mix_aggregate"] = dict(ms=ms_k, plain_ms=ms_p, library_ms=ms_l,
                                 bound_ms=b_ms, bound_by=b_by,
                                 max_abs_err=max(e_mix, e_ma))
    print(f"{tag} mix_aggregate @ LM payload ({n}, {p}) bf16, route "
          f"{route}: {ms_k:.4f} ms (plain, in column chunks, {ms_p:.4f} "
          f"ms, torch.matmul in bf16 {ms_l:.4f} ms, bound {b_ms:.4f} ms by "
          f"{b_by}: {b_ms / ms_k:.1%} of it; mixed: max|mixed| "
          f"{m_max:.3e}, {same / X.numel():.4%} of values equal to the "
          f"plain version's, max|err| {e_mix:.3e} = {u_mix:.2f} bf16 ulps "
          f"of the value (gate {MIXED_ULPS}); agg max|err| {e_ma:.3e}, at "
          f"most {r_ma:.3e} of sum |w_i X_i| (gate {AGG_REL:.0e}))")
    del X, Bb, wb
    torch.cuda.empty_cache()
    if moe.expert_matmul.routes != expert_routes:
        raise AssertionError(f"{tag} expert_matmul routes {expert_routes} "
                             f"-> {moe.expert_matmul.routes}: a grouped "
                             "route ran under vmap")
    if cfg.n_experts:
        print(f"{tag} expert_matmul routes unchanged by the training "
              f"({moe.expert_matmul.routes}): every MoE layer ran the "
              "dense oracle under vmap")

    # (c) where a round's time goes: one traced 'aggregate' round
    args = (A, tau, m3, eta)
    if extras:
        round_fn = make_round_fn(model.loss, "aggregate")
        reset_counters(counters)
        trace_device(lambda: round_fn(params, batch, *args),
                     f"{cfg.name} bf16, one 'aggregate' round ({LMT_N} x "
                     f"{LMT_T} x {S} tokens; warm from the runs above)",
                     top=14, warm=False)
        del round_fn
    del params, model, batch
    torch.cuda.empty_cache()

    # (d) the fp32 pins at full width, pin_layers layers
    cfg32 = lm_train_config(arch, n_layers=pin_layers, dtype="float32")
    m32 = Model(cfg32)
    p32 = m32.init(torch.Generator(device=dev).manual_seed(seed + 1))
    s32 = lm_train_data(cfg32, seed, pin_s, n=pin_n)
    einsum32 = _lm_server(cfg32, p32, s32, seed, n=pin_n, backend="einsum")
    einsum32.run()
    for backend, record_mixed, scan in (("fused", False, False),
                                        ("fused", True, False),
                                        ("fused", False, True)):
        srv = _lm_server(cfg32, p32, s32, seed, n=pin_n, backend=backend,
                         record_mixed=record_mixed, scan=scan)
        srv.run()
        worst, _ = _leaves_close(f"fp32 {srv.effective_backend}",
                                 srv.params, einsum32.params, ORACLE_F32)
        print(f"{tag} fp32 pin, {cfg32.n_layers} layers, n {pin_n}, S "
              f"{pin_s}: {srv.effective_backend}"
              f"{' scanned' if scan else ''} vs einsum max|d| {worst:.3e} "
              f"(rtol 2e-4, atol 2e-5)")
        if scan:
            seq = _lm_server(cfg32, p32, s32, seed, n=pin_n, backend=backend)
            seq.run()
            _bitwise("fp32 scanned vs sequential", srv.params, seq.params)
            print(f"{tag} fp32 pin: scanned == sequential bitwise")
            del seq
        del srv
    if not extras:
        del einsum32, p32, m32
        torch.cuda.empty_cache()
        return launches, rows
    batch32 = tuple(b.to(dev) for b in s32(np.random.default_rng(seed), 0))
    for backend in ("aggregate", "fused", "einsum"):
        fn = make_round_fn(m32.loss, backend)
        _bitwise(f"fp32 all-ones active on {backend}",
                 fn(p32, batch32, *args, torch.ones(n, device=dev))[0],
                 fn(p32, batch32, *args)[0])
    print(f"{tag} fp32 pin: all-ones active == None bitwise on "
          "aggregate, fused, einsum")
    off = make_round_fn(Model(dataclasses.replace(cfg32, remat=False))
                        .loss, "aggregate")(p32, batch32, *args)[0]
    on = make_round_fn(m32.loss, "aggregate")(p32, batch32, *args)[0]
    _bitwise("fp32 remat on vs off", on, off)
    print(f"{tag} fp32 pin: remat on == off bitwise")
    del einsum32, p32, m32, batch32, on, off
    torch.cuda.empty_cache()
    return launches, rows


def phase_mesh(seed: int, counters) -> int:
    """The mesh runtime (``fl/distributed.py``) on the card: a world-size-1
    NCCL group in this process (a file store in a temporary directory),
    mesh (1, 1, 1), stablelm-1.6b bf16 at full width and MESH_LAYERS
    layers, one
    client of MESH_S tokens a step.  Each of the five schedules runs
    LMT_ROUNDS rounds sequentially and scanned (bitwise equal) and is
    held against ``LocalEngine``'s round function at n = 1 on the same
    inputs (the change from init, ``_change_stats``, within
    CHANGE_REL[0]); 'fused' must launch aggregate once a round.
    Returns fused's aggregate launches."""
    import tempfile
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.rounds import make_round_fn
    from repro_torch.fl import distributed as D
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import Model

    dev = torch.device("cuda")
    torch.cuda.set_device(0)
    cfg = lm_train_config(n_layers=MESH_LAYERS)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed + 2))
    sampler = lm_train_data(cfg, seed, MESH_S, n=1)
    rng = np.random.default_rng(seed)
    xs, ys = zip(*(sampler(rng, t) for t in range(LMT_ROUNDS)))
    xs, ys = torch.stack(xs).to(dev), torch.stack(ys).to(dev)
    toks = torch.cat([xs, ys[..., -1:]], dim=-1)      # (K, 1, T, B, S+1)
    A = torch.ones(LMT_ROUNDS, 1, 1, device=dev)
    tau = torch.ones(LMT_ROUNDS, 1, device=dev)
    m = torch.ones(LMT_ROUNDS, device=dev)
    eta = torch.full((LMT_ROUNDS,), LMT_ETA, device=dev)
    local = make_round_fn(model.loss, "einsum")
    want = params
    for t in range(LMT_ROUNDS):
        want, _ = local(want, (xs[t], ys[t]), A[t], tau[t], m[t], eta[t])
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_debug_mesh((1, 1, 1))
            print(f"[mesh] {dist.get_backend()} world size "
                  f"{dist.get_world_size()}, mesh "
                  f"{tuple(mesh.shape)} {mesh.mesh_dim_names}; "
                  f"{cfg.name} bf16 {cfg.n_layers} layers, T {LMT_T}, S "
                  f"{MESH_S}, {LMT_ROUNDS} rounds a run")
            fused_launches = 0
            for mixing in D.MIXINGS:
                step = D.make_train_step(cfg, mesh, mixing=mixing)
                reset_counters(counters)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                p = params
                for t in range(LMT_ROUNDS):
                    p = step(p, toks[t], A[t], tau[t], m[t], eta[t])
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / LMT_ROUNDS
                counts = {k: f.launches for k, f in counters.items()
                          if f.launches}
                wanted = {"aggregate": LMT_ROUNDS} if mixing == "fused" \
                    else {}
                wanted.update(flash_launches(cfg, LMT_ROUNDS * LMT_T))
                if counts != wanted:
                    raise AssertionError(f"[mesh] {mixing}: launches "
                                         f"{counts}, not {wanted}")
                fused_launches += counts.get("aggregate", 0)
                scanned = D.make_scanned_train_steps(cfg, mesh, LMT_ROUNDS,
                                                     mixing=mixing)
                final, seq = scanned(params, toks, A, tau, m, eta)
                del seq
                _bitwise(f"[mesh] {mixing} scanned vs sequential", final, p)
                r = _change_stats(p, want, params, dev)
                print(f"[mesh] {mixing}: {ms:.1f} ms a round, launches "
                      f"{counts or 'none'}; scanned == sequential bitwise; "
                      f"vs LocalEngine (n = 1): LocalEngine moved "
                      f"{r['moved']:.3%} of values from init, the change "
                      f"off by ||d - d_local|| / ||d_local|| "
                      f"{r['rel']:.4e} (gate {CHANGE_REL[0]}), "
                      f"{r['differ']:.4%} of values differ")
                if r["moved"] < MOVED_MIN or r["rel"] > CHANGE_REL[0]:
                    raise AssertionError(
                        f"[mesh] {mixing} vs LocalEngine: moved "
                        f"{r['moved']:.3%}, change off by {r['rel']:.3e}")
                del p, final
                torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    del params, want, model
    torch.cuda.empty_cache()
    return fused_launches


def phase_moetrain(seed: int, counters):
    """[moetrain]: ``phase_lmtrain``'s recipe on MOET_ARCH at full width
    and MOET_LAYERS layers, MOET_S tokens a client a step; fp32 pins at
    MOET_LAYERS layers, MOET_PIN_N clients of MOET_PIN_S tokens (no trace,
    no all-ones or remat pins: [lmtrain] holds those on the same code)."""
    import torch
    from repro_torch.configs import get_config
    full = get_config(MOET_ARCH)
    print(f"[moetrain] cuts, each forced by the card's 80 GB: depth "
          f"{MOET_LAYERS} of {full.n_layers} layers, {MOET_S:,} of "
          f"[lmtrain]'s {LMT_S:,} tokens a client a step (the dense "
          f"oracle's activations: at 4,096 the phase alone peaks at 75.9 "
          f"GB); fp32 pins "
          f"at {MOET_PIN_N} clients of "
          f"{MOET_PIN_S} tokens; every width published")
    # after the script's earlier phases the allocator's segments are cut
    # to their sizes: in the whole script the record_mixed run (70.8 GB at
    # its peak alone) found 23 GB reserved but unusable beside 49.8 GB
    # allocated.  This phase grows its segments in place, as [tp]'s ranks
    # do, and leaves the setting as it found it.
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        return phase_lmtrain(seed, counters, arch=MOET_ARCH,
                             layers=MOET_LAYERS, S=MOET_S,
                             pin_layers=MOET_LAYERS, pin_n=MOET_PIN_N,
                             pin_s=MOET_PIN_S, extras=False,
                             tag="[moetrain]")
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")


def zoot_memory_depth(arch: str) -> int:
    """The most layers of ``arch`` (whole hybrid groups) whose bf16 tree,
    ZOOT_TREES times over, stays under ZOOT_PEAK_GB."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    step = full.hybrid_attn_every if full.family == "hybrid" else 1
    fits = [n for n in range(step, full.n_layers + 1, step)
            if lm_train_config(arch, n_layers=n).param_count() * 2
            * ZOOT_TREES <= ZOOT_PEAK_GB * 1e9]
    return max(fits, default=0)


def phase_zootrain(seed: int, counters):
    """[zootrain]: ``phase_lmtrain``'s recipe on each of ZOOT_ARCHS at its
    published widths, cut depth and tokens a client a step, every
    run's peak under ZOOT_PEAK_GB; fp32 pins at the pin depth, ZOOT_PIN_N
    clients of ZOOT_PIN_S tokens (no trace, no all-ones or remat pins:
    [lmtrain] holds those on the same code).  Returns ({kernel: launches
    summed over the archs}, {arch: {kernel: row fields at its
    payload}})."""
    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    launches, rows = {}, {}
    # segments grown in place, as [moetrain]'s, the setting restored after
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        for arch, layers, S, pin_layers, why in ZOOT_ARCHS:
            full = get_config(arch)
            cap = zoot_memory_depth(arch)
            tree = lm_train_config(arch, n_layers=layers).param_count() * 2
            print(f"[zootrain] {arch}: {layers} of {full.n_layers} layers"
                  + (f" ({layers // full.hybrid_attn_every} groups of "
                     f"{full.hybrid_attn_every} Mamba blocks + the shared "
                     "block)" if full.family == "hybrid" else "")
                  + (f", {S:,} of [lmtrain]'s {LMT_S:,} tokens a client a "
                     "step" if S != LMT_S else "")
                  + f", a {tree / 1e9:.2f} GB bf16 tree (the tree rule, "
                  f"{ZOOT_TREES} trees <= {ZOOT_PEAK_GB} GB, allows {cap} "
                  f"layers); cut by {why}"
                  + f"; fp32 pins at {pin_layers} layers, {ZOOT_PIN_N} "
                  f"clients of {ZOOT_PIN_S} tokens; every width published",
                  flush=True)
            if layers > cap:
                raise AssertionError(f"[zootrain] {arch} at {layers} layers "
                                     f"is past the memory rule's {cap}")
            got, got_rows = phase_lmtrain(
                seed, counters, arch=arch, layers=layers, S=S,
                pin_layers=pin_layers, pin_n=ZOOT_PIN_N, pin_s=ZOOT_PIN_S,
                extras=False, tag="[zootrain]", max_peak_gb=ZOOT_PEAK_GB)
            for kernel, count in got.items():
                launches[kernel] = launches.get(kernel, 0) + count
            rows[arch] = got_rows
            torch.cuda.empty_cache()
    finally:
        torch.cuda.memory._set_allocator_settings(
            "expandable_segments:False")
    print(f"[zootrain] phase {time.perf_counter() - t0:.1f} s (budget "
          f"{ZOOT_BUDGET_S} s)")
    return launches, rows


# -- [serve]: the serving CLI's own function -----------------------------------

# the CLI's reduced configs (vocab 512, fp32, its defaults: batch 4, 32
# prompt tokens, 16 new) on a world of one: a dense, an MoE and an SSD arch
SERVE_ARCHS = ("qwen2-7b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b")
SERVE_TOL = 2e-4


def phase_serve(seed: int, counters) -> None:
    """``launch/serve.py``'s per-rank function (``serve.serve_rank``, what
    ``python -m repro_torch.launch.serve --devices 1`` runs) on the card,
    a world-size-1 NCCL group in this process, for SERVE_ARCHS: the CLI's
    lines (prefill and decode ms), and its tokens and logits against the
    one-device ``Model.prefill`` / ``decode`` on the weights it drew (the
    greedy tokens equal, logits within SERVE_TOL); the launches counted
    (the reduced configs attend on 'ref': none)."""
    import contextlib
    import io
    import tempfile
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    for arch in SERVE_ARCHS:
        args = serve.parse_args(["--devices", "1", "--arch", arch,
                                 "--seed", str(seed)])
        args.device = "cuda"
        reset_counters(counters)
        printed = io.StringIO()
        with tempfile.TemporaryDirectory() as tmp, \
                contextlib.redirect_stdout(printed):
            out = serve.serve_rank(0, args, f"{tmp}/store")
        counts = {k: f.launches for k, f in counters.items() if f.launches}
        for line in printed.getvalue().splitlines():
            print(f"[serve]   {line}")
        cfg, params = out["cfg"], out["params"]
        B, K, new = args.batch, args.prompt_len, args.new_tokens
        rng = np.random.default_rng(seed)
        prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, K)),
                                  device="cuda")
        model = Model(cfg)
        with torch.no_grad():
            logits, cache = model.prefill(params, prompts, max_len=K + new)
            steps = [logits]
            for i in range(new - 1):
                logits, cache = model.decode(params, cache,
                                             torch.argmax(logits, -1), K + i)
                steps.append(logits)
        want = torch.stack(steps, 1).float()
        d = float((out["logits"] - want).abs().max())
        same = torch.equal(out["tokens"], torch.argmax(want, -1))
        print(f"[serve] {cfg.name} on mesh {out['mesh']}: "
              f"{out['prefill_s'] * 1e3:.2f} ms prefill, "
              f"{out['decode_s'] * 1e3 / (new - 1):.2f} ms a decode step; "
              f"launches {counts or 'none'}; against Model.prefill / decode "
              f"on its weights: max|dlogits| {d:.3e} (gate {SERVE_TOL}), "
              f"greedy tokens {'equal' if same else 'DIFFER'}")
        if not same or not torch.allclose(out["logits"], want,
                                          rtol=SERVE_TOL, atol=SERVE_TOL) \
                or not bool(torch.isfinite(out["logits"]).all()):
            raise AssertionError(f"[serve] {arch}: the CLI's serve is not "
                                 "the one-device path's")
        del out, params, model, cache, want
        torch.cuda.empty_cache()


# -- phase 5c: tensor parallelism inside a client ------------------------------

# The default run: two ranks on the one card (gloo takes CUDA tensors for
# all_reduce / broadcast; NCCL refuses two ranks on one device), mesh (1,
# 1, 2).  (a) stablelm-1.6b as [mesh] trains it, on 'fused' and 'ring',
# and (f) on 'ring' with sequence parallelism and the SP-MLP (the
# sequence collectives' broadcast route); (b) qwen2-7b served whole
# through the mesh prefill / decode steps at m = 2: 28 q / 4 kv heads, 14
# / 2 a rank, flash on the tensor-core route; (c) mamba2-1.3b and
# zamba2-2.7b served whole (SSD heads 32 / 40 a rank, zamba2's shared
# block 16 / 16 heads at head dim 80 through flash); (d) deepseek-v2 at
# full width served at 1 + TP_DSV2_MOE layers (MLA 64 heads a rank,
# tensor-parallel experts); (e) phi3.5-moe at full width, TP_EP_LAYERS
# layers, one whole expert of 16 in 8 a rank (moe_sharding='expert'):
# forward and gradient against the one-device ragged path.
TP_SHAPE, TP_BACKEND = (1, 1, 2), "gloo"
# (schedule, sequence parallel): (a) and (f)
TP_CASES = (("fused", False), ("ring", False), ("ring", True))
TP_SERVE_ARCH, TP_SERVE_LAYERS, TP_SERVE_TOL = "qwen2-7b", 4, 2e-4
# served archs without a router ((c)), the bf16 greedy tokens (LM_BATCH x
# LM_NEW = 32 of them).  At m = 2 they agree with one device's at least
# TP_TOP1_MIN of the time (mamba2 and zamba2 0.9375 on an H100, two gloo
# ranks).  At m = 4 two bf16 runs drift further apart with no fault: on
# four H100s over NCCL mamba2 read 0.8125 and zamba2 0.875 with every fp32
# gate held, and the one-device bf16 run itself read 0.84375 / 0.875
# against a one-device fp32 run of the same weights.  So from m = 4 on
# (``top1_low``) the m-way run's top-1 against that fp32 run must be no
# worse than the one-device bf16 run's, less TP_TOP1_DELTA (2 of the 32
# tokens; bf16 alone moved zamba2's by 1 of 32 at m = 2).  On four H100s
# a sound run reads mesh 0.875 against one device's 0.84375 (mamba2) and
# 0.875 / 0.875 (zamba2); a run whose rank 0 scales its SSD out-projection
# partial sum by 0.75 before the all-reduce reads 0.0625 against 0.78125
# and 0.875.
TP_TOP1_MIN = 0.9
TP_TOP1_DELTA = 1 / 16
# (c) / (d): (case, arch, depth (None: whole), fp32 gate layers, bf16
# top-1 gate (None: printed only)); each fp32 gate prefills TP_GATE_S
# tokens a row (fewer chances for a router's top-k to flip on a last-bit
# difference than LM_SEQ)
TP_DSV2_MOE = 4
TP_ZOO_SERVE = (("c", "mamba2-1.3b", None, 6, TP_TOP1_MIN),
                ("c", "zamba2-2.7b", None, 6, TP_TOP1_MIN),
                ("d", "deepseek-v2-236b", 1 + TP_DSV2_MOE, 2, None))
TP_GATE_S = 256
# the cases (c) - (e) phase_tp runs after (a), (f) and (b)
TP_ZOO = ("c", "d", "e")   # the four-card recipe adds "g" (below)
# (e): layers, the bf16 batch (B, S), the fp32 gate's layers and tokens
# (at 8 tokens top-2 of 16 experts the capacity, max(2 T k / E, 8) = 8,
# holds every token: no slot can be dropped, so the gate compares the
# same function)
TP_EP_ARCH, TP_EP_LAYERS, TP_EP_B, TP_EP_S = "phi3.5-moe-42b-a6.6b", 4, 1, 1024
TP_EP_GATE_LAYERS, TP_EP_GATE_S = 2, 8
# (g), in the four-card recipe: deepseek-v2 (src/repro/configs/
# deepseek_v2_236b.py, arXiv:2405.04434) trained federated at its
# published widths and 1 + 1 of its 60 layers (the dense one and one MoE
# layer: ~5.4e9 values a client, 3.77e9 of them the 160 experts; at n = 2
# a single-host round holds >= 4 bf16 trees of 21 GB, so one card cannot
# take it), moe_sharding 'tensor' (the expert layout refuses under a
# model group), TP_TRAIN_S tokens a client a step, LMT_T steps,
# LMT_ROUNDS rounds on mesh ``shape`` ((1, 2, 2): 2 clients of 2 ranks)
# on each of TP_TRAIN_MIXINGS (schedule, zero), 'fused' and 'ring' held
# against 'einsum' on the same mesh by CHANGE_REL / MOVED_MIN; then fp32
# on mesh ``serve_shape`` ((1, 1, 4)): one client's loss and gradient on
# TP_TRAIN_GATE_S tokens against the one-device path, within ORACLE_F32
TP_TRAIN_ARCH, TP_TRAIN_LAYERS, TP_TRAIN_S = "deepseek-v2-236b", 2, 1024
TP_TRAIN_MIXINGS = (("einsum", False), ("fused", False), ("ring", True))
TP_TRAIN_GATE_S = 256
# flash on a rank's own layer-0 q / k / v against its plain version, bf16
# ([flash]'s tolerance)
TP_FLASH_TOL = 2e-2
# a collective that waits this long has lost a rank
TP_TIMEOUT_S = 300
# The bf16 run is held to LocalEngine's by the change from init after
# every round.  A tensor-parallel layer's all_reduce rounds the ranks' bf16
# partial sums once more than one GEMM does (as the reference's GSPMD
# does), from the first step on, and bf16 local SGD amplifies that, so
# CHANGE_REL[0] ([mesh]'s gate for a run bitwise LocalEngine's in local
# SGD) cannot hold.  The gate lies between a sound run's readings and those
# of a run whose D2S add is scaled by 0.75, on an H100 at mesh (1, 1, 2):
# 0.151 / 0.155 and 0.285 / 0.293 after rounds 0 / 1 (0.215 after round 1
# at (2, 1, 2) on four cards).
TP_CHANGE_REL = 0.25
# rank 0's op_cost tally of (b)'s warm-up prefill, by arch ([dryrun] (3))
TP_PREFILL_TALLY = {}


def layered_params(cfg, seed: int, place=None):
    """Random weights for ``cfg`` drawn on the card a layer at a time (the
    embeddings, head and layer 0 from generator ``seed``, layer i from
    ``seed + i``), each tree kept whole or passed through ``place`` (a
    tree -> this rank's shards) as it is drawn and written into the
    stacked leaves: beside what is kept, one whole layer is alive at a
    time (qwen3-32b's 65.5 GB never are)."""
    import dataclasses
    import torch
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    from repro_torch.models import blocks
    from repro_torch.models.model import Model

    dev = torch.device("cuda", torch.cuda.current_device())
    # the first draw holds the leading dense layers (deepseek-v2's) and
    # one stacked layer; each later draw one stacked layer alone, copied
    # into its row of the stacked leaves
    one = dataclasses.replace(cfg, n_layers=cfg.first_dense_layers + 1)
    rest = dataclasses.replace(cfg, n_layers=1, first_dense_layers=0)
    keep = place or (lambda tree: tree)
    top = keep(Model(one, device=dev).init(
        torch.Generator(device=dev).manual_seed(seed)))
    first, treedef = tree_flatten(top["decoder"]["layers"])
    n = cfg.n_layers - cfg.first_dense_layers
    stacked = [torch.empty((n,) + tuple(a.shape[1:]), dtype=a.dtype,
                           device=a.device) for a in first]
    for o, a in zip(stacked, first):
        o[:1] = a
    del first, top["decoder"]["layers"]
    for i in range(1, n):
        d = blocks.stack_init(torch.Generator(device=dev).manual_seed(seed + i),
                              rest, top["final_norm"].dtype)
        layer = keep({"decoder": {"layers": d["layers"]}})["decoder"]["layers"]
        del d
        for o, a in zip(stacked, tree_flatten(layer)[0]):
            o[i:i + 1] = a
        del layer
    top["decoder"]["layers"] = tree_unflatten(treedef, stacked)
    return top


def _one_rank_at_a_time(mesh, fn):
    """``fn()`` on each rank of the model group in turn, a barrier
    between: one rank's transient draws (a whole layer, its fp32 copy)
    are alive on a shared card at a time, and each rank hands their
    memory back to the card before the next draws."""
    import torch
    import torch.distributed as dist

    m = int(mesh.shape[mesh.mesh_dim_names.index("model")])
    group = mesh.get_group("model") if m > 1 else None
    out = None
    for r in range(m):
        if int(mesh.get_local_rank("model")) == r:
            out = fn()
            torch.cuda.empty_cache()
        if group is not None:
            dist.barrier(group=group)
    return out


def _placer(cfg, mesh):
    """A tree -> this rank's shards of it (``sharding.placement_specs``),
    for any subtree of the model's params."""
    from repro_torch.core.pytree import tree_flatten, tree_unflatten
    from repro_torch.models import sharding

    m = int(mesh.shape[mesh.mesh_dim_names.index("model")])
    r = int(mesh.get_local_rank("model"))

    def place(tree):
        leaves, treedef = tree_flatten(tree)
        specs = sharding.spec_leaves(sharding.placement_specs(tree, cfg, m))
        return tree_unflatten(treedef, [sharding.local_shard(x, s, r, m)
                                        for x, s in zip(leaves, specs)])
    return place


def _timed_launches(t0, counters):
    """(ms a round since ``t0`` over LMT_ROUNDS rounds, the launches
    counted)."""
    import torch
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / LMT_ROUNDS
    return ms, {k: f.launches for k, f in counters.items() if f.launches}


def _count_seq_routes(sharding):
    """A counter of the routes ``sharding.seq_route`` picks from now on
    (``.plain``: the function it wraps, to put back)."""
    import collections

    seen = collections.Counter()
    plain = sharding.seq_route

    def counted(group, x):
        route = plain(group, x)
        seen[route] += 1
        return route

    seen.plain = plain
    sharding.seq_route = counted
    return seen


def _case_key(mixing: str, sp: bool) -> str:
    return f"{mixing}+sp" if sp else mixing


def _tp_rank(rank, tmp, shape, backend, zero, serve_arch, serve_shape, seed,
             zoo):
    """One rank of ``phase_tp`` (a spawned process): (a), (f), (b) and,
    and the cases of ``zoo`` among (c) - (e) on its shards, its numbers to
    ``tmp/rank{rank}.json``.  Rank 0 also runs LocalEngine's round
    function on the whole params and holds the gathered params' change
    from init to it (``_change_stats``), so no params leave the card."""
    import faulthandler
    from datetime import timedelta
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.core.rounds import make_round_fn
    from repro_torch.fl import distributed as D
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import sharding
    from repro_torch.models.model import Model

    # a rank stuck outside a collective (which times out by itself)
    # prints where it is
    faulthandler.dump_traceback_later(2 * TP_TIMEOUT_S)
    world = 1
    for k in shape:
        world *= k
    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=TP_TIMEOUT_S),
                            **({"device_id": dev} if backend == "nccl"
                               else {}))
    try:
        counters = kernel_counters()
        out = {"rank": rank, "device": str(dev)}
        mesh = make_debug_mesh(shape)
        inp = torch.load(Path(tmp) / "train.pt")
        toks, A, tau, m, eta = (inp[k].to(dev) for k in
                                ("toks", "A", "tau", "m", "eta"))
        cfg = lm_train_config()
        model = Model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(seed + 2))
        if rank == 0:
            local_round = make_round_fn(model.loss, "einsum")
            refs, ref = [], params
            for t in range(LMT_ROUNDS):
                ref, _ = local_round(ref, (toks[t][..., :-1],
                                           toks[t][..., 1:]),
                                     A[t], tau[t], m[t], eta[t])
                refs.append(ref)
            del local_round, ref
            torch.cuda.empty_cache()
        for mixing, sp in TP_CASES:
            key = _case_key(mixing, sp)
            z = zero and mixing == "ring" and not sp
            local = D.shard_params(params, cfg, mesh, zero=z)
            if (mixing, sp) == TP_CASES[-1] and rank:
                del params
            sharding.set_activation_sharding("model" if sp else None,
                                             sp_mlp=sp)
            seq_routes = _count_seq_routes(sharding)
            try:
                step = D.make_train_step(cfg, mesh, mixing=mixing, zero=z)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                dist.barrier()
                reset_counters(counters)
                t0 = time.perf_counter()
                p = local
                # (f) is timed on the scanned run alone
                for t in range(0 if sp else LMT_ROUNDS):
                    p = step(p, toks[t], A[t], tau[t], m[t], eta[t])
                if not sp:
                    ms, counts = _timed_launches(t0, counters)
                final, seq = D.make_scanned_train_steps(
                    cfg, mesh, LMT_ROUNDS, mixing=mixing, zero=z)(
                        local, toks, A, tau, m, eta)
                if sp:
                    ms, counts = _timed_launches(t0, counters)
                    p = final
                want = {"aggregate": LMT_ROUNDS} if mixing == "fused" \
                    else {}
                # each rank trains its one client: T steps a round
                want.update(flash_launches(cfg, LMT_ROUNDS * toks.shape[2]))
                if counts != want:
                    raise AssertionError(f"[tp] rank {rank} {key}: "
                                         f"launches {counts}, not {want}")
            finally:
                sharding.set_activation_sharding(None)
                sharding.seq_route = seq_routes.plain
            # the sequence collectives ran, on the backend's route, only
            # where sequence parallelism is on
            route = "broadcast" if backend == "gloo" else "collective"
            if (set(seq_routes) != {route}) if sp else bool(seq_routes):
                raise AssertionError(f"[tp] rank {rank} {key}: sequence "
                                     f"collectives by route {seq_routes}")
            if not sp:
                _bitwise(f"[tp] rank {rank} {key} scanned vs sequential",
                         final, p)
            out[key] = dict(
                ms=ms, counts=counts, seq_routes=dict(seq_routes),
                local_gb=sum(x.numel() * x.element_size()
                             for x in tree_leaves(p)) / 1e9,
                peak_gb=torch.cuda.max_memory_allocated() / 1e9)
            # the change from init after each round (row t of the scanned
            # run, bitwise the sequential one), read and printed by rank 0
            # as it comes, so a run that fails later still shows it
            for t in range(LMT_ROUNDS):
                whole = D.gather_params(tree_map(lambda x: x[t], seq), cfg,
                                        mesh, zero=z)
                if rank == 0:
                    r = _change_stats(whole, refs[t], params, dev)
                    out[f"change/{key}/r{t}"] = r
                    print(f"[tp]   {key}{' zero' if z else ''} after "
                          f"round {t}: LocalEngine (n = {world // shape[-1]})"
                          f" moved {r['moved']:.3%} of values from init; "
                          f"the change off by ||d - d_local|| / ||d_local||"
                          f" {r['rel']:.4e} (gate {TP_CHANGE_REL}), "
                          f"{r['differ']:.4%} of values differ", flush=True)
                del whole
            del local, p, final, seq
            torch.cuda.empty_cache()

        if rank == 0:
            del params, refs
        torch.cuda.empty_cache()

        # fp32 pins: one round on each case against the one-rank round
        # function (LocalEngine's) on the whole params
        cfg32 = lm_train_config(n_layers=LMT_PIN_LAYERS, dtype="float32")
        m32 = Model(cfg32)
        p32 = m32.init(torch.Generator(device=dev).manual_seed(seed + 3))
        x32 = inp["toks32"].to(dev)
        want = make_round_fn(m32.loss, "einsum")(
            p32, (x32[..., :-1], x32[..., 1:]), A[0], tau[0], m[0],
            eta[0])[0]
        for mixing, sp in TP_CASES:
            key = _case_key(mixing, sp)
            z = zero and mixing == "ring" and not sp
            sharding.set_activation_sharding("model" if sp else None,
                                             sp_mlp=sp)
            try:
                got = D.gather_params(D.make_train_step(
                    cfg32, mesh, mixing=mixing, zero=z)(
                        D.shard_params(p32, cfg32, mesh, zero=z), x32, A[0],
                        tau[0], m[0], eta[0]), cfg32, mesh, zero=z)
            finally:
                sharding.set_activation_sharding(None)
            out[f"pin32/{key}"] = _leaves_close(
                f"[tp] rank {rank} fp32 {key} vs the one-rank round",
                got, want, ORACLE_F32)
            del got
        del p32, want, m32
        torch.cuda.empty_cache()

        # (b) serving through the mesh steps; the whole batch on every
        # client of serve_shape (no batch axis)
        out["serve"] = _tp_serve(rank, serve_arch, serve_shape, seed,
                                 counters)
        # (c), (d) the SSD, hybrid and MLA archs served; (e) the
        # expert-parallel MoE
        for case, arch, depth, gate_layers, top1 in TP_ZOO_SERVE:
            if case in zoo:
                out[f"serve/{arch}"] = _tp_serve(
                    rank, arch, serve_shape, seed, counters, depth=depth,
                    gate_layers=gate_layers, gate_s=TP_GATE_S,
                    top1_min=top1)
        if "e" in zoo:
            out["ep"] = _tp_ep(rank, serve_shape, seed)
        # (g) deepseek-v2 trained federated over the clients' model axis
        if "g" in zoo:
            out["train"] = _tp_train(rank, shape, serve_shape, seed,
                                     counters)
        with open(Path(tmp) / f"rank{rank}.json", "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        faulthandler.cancel_dump_traceback_later()
        dist.destroy_process_group()


def _first_flash_call(fn):
    """``fn()`` with ``ops.flash_attention`` wrapped to keep its first
    call's arguments: (q, k, v, options), the model's (B, S, H, hd)
    tensors."""
    from repro_torch.kernels.flash_attention import ops

    seen, plain = [], ops.flash_attention

    def keep(q, k, v, **kw):
        if not seen:
            seen.append((q, k, v, kw))
        return plain(q, k, v, **kw)

    ops.flash_attention = keep
    try:
        fn()
    finally:
        ops.flash_attention = plain
    if not seen:
        raise AssertionError("[tp] the serve steps never called flash")
    return seen[0]


def _flash_on_rank(q, k, v, kw) -> dict:
    """The flash kernel against ``flash_attention_ref`` on one rank's own
    attention inputs (its heads, in the model's strided layout, as
    ``ops.flash_attention`` hands them over), bf16 at TP_FLASH_TOL, on the
    tensor-core route.  Every rank of the group learns whether any
    disagreed (an all-reduce), so all fail together."""
    import torch
    import torch.distributed as dist
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref

    q, k, v = (t.transpose(1, 2) for t in (q, k, v))     # (B, H, S, hd)
    before = dict(fa.flash_attention_cuda.routes)
    got = fa.flash_attention_cuda(q, k, v, **kw)
    route = [r for r in before
             if fa.flash_attention_cuda.routes[r] != before[r]]
    want = flash_attention_ref(q, k, v, **kw)
    err = float((got.float() - want.float()).abs().max())
    ok = route == ["tensor_cores"] and torch.allclose(
        got.float(), want.float(), rtol=TP_FLASH_TOL, atol=TP_FLASH_TOL)
    bad = torch.tensor([0.0 if ok else 1.0], device=q.device)
    dist.all_reduce(bad, op=dist.ReduceOp.MAX)
    res = dict(shape=[q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                      q.shape[3]], dtype=str(q.dtype), route=route,
               max_abs_err=err)
    if bad.item():
        raise AssertionError(f"[tp] flash on a rank's own q / k / v "
                             f"disagrees with flash_attention_ref or took "
                             f"another route (this rank: {res})")
    return res


def _top1(a, b) -> float:
    """The share of positions whose greedy token (argmax over the last
    dim) ``a`` and ``b`` agree on."""
    return float((a.argmax(-1) == b.argmax(-1)).float().mean())


def top1_low(m: int, top1: float, vs_fp32=None) -> bool:
    """Whether an m-way bf16 serve run fails the top-1 rule: at m < 4 its
    greedy tokens agree with the one-device bf16 run's (``top1``) less
    than TP_TOP1_MIN of the time; from m = 4 on, against the one-device
    fp32 run (``vs_fp32``: {'mesh': .., 'one_device': ..}, both bf16 runs'
    top-1 against it), it is more than TP_TOP1_DELTA under the one-device
    bf16 run."""
    if m < 4:
        return top1 < TP_TOP1_MIN
    if vs_fp32 is None:
        raise ValueError(f"the top-1 rule at m = {m} needs the one-device "
                         "fp32 run's readings")
    return vs_fp32["mesh"] < vs_fp32["one_device"] - TP_TOP1_DELTA


def _rank_heads(cfg, local) -> tuple:
    """The heads a rank's layer 0 holds: (q, kv) of GQA (zamba2's shared
    block), MLA's q heads, the SSD's heads."""
    dec = local["decoder"]
    if cfg.family in ("ssm", "hybrid"):
        ssd = dec["layers"]["ssm"]["w_x"].shape[-1] // cfg.ssm_head_dim
        if cfg.family == "ssm":
            return (ssd,)
        attn = dec["shared"]["attn"]
    elif cfg.mla:
        mla = dec["layers"]["mla"]
        wq = mla["wq_b"] if cfg.q_lora_rank else mla["wq"]
        return (wq.shape[-1] // (cfg.nope_head_dim + cfg.rope_head_dim),)
    else:
        attn, ssd = dec["layers"]["attn"], None
    hd = cfg.resolved_head_dim
    heads = (attn["q"]["w"].shape[-1] // hd, attn["k"]["w"].shape[-1] // hd)
    return heads if ssd is None else heads + (ssd,)


def _tp_serve(rank, arch, shape, seed, counters, depth=None,
              gate_layers=TP_SERVE_LAYERS, gate_s=None, top1_min=None):
    """(b) - (d) of ``phase_tp`` on one rank: ``arch`` in bf16 at full
    width (``depth`` layers, whole by default) on mesh ``shape`` through
    ``make_prefill_step`` / ``make_decode_step``, LM_BATCH x LM_SEQ prompt
    tokens and LM_NEW greedy decode steps, launches counted from 0 (flash
    once a GQA layer, zamba2's shared block once a group); the flash
    kernel held against its plain version on the rank's own layer-0 q / k
    / v (from the warm-up, ``_flash_on_rank``); against the one-device
    ``Model.prefill`` / ``decode`` on the same weights where the whole
    model fits beside the other ranks' shards (the greedy tokens' top-1
    agreement); then the fp32 gate at ``gate_layers`` layers on ``gate_s``
    prompt tokens a row (LM_SEQ by default).  Where ``top1_min`` is given
    (a gated arch), rank 0 also runs the one-device path in fp32 on the
    same weights (upcast) and tokens, and reads both bf16 runs' top-1
    against it: how far bf16 alone moves the greedy tokens.  ``phase_tp``
    reads the top-1 rule (``top1_low``) once every case has run, so a low
    reading does not stop the fp32 gates."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.fl import distributed as D
    from repro_torch.kernels.flash_attention import flash_attention as fa
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import Model
    from repro_torch.roofline import OpCost

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_debug_mesh(shape)
    base = get_config(arch)
    cfg = dataclasses.replace(base, attn_impl="flash",
                              n_layers=depth or base.n_layers)
    B, S, new = LM_BATCH, LM_SEQ, LM_NEW
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                           device=dev)
    flash = expected_flash(cfg)
    out = {"layers": cfg.n_layers, "top1_min": top1_min}

    def run(c, local, toks, n_new, tally=None):
        S = toks.shape[1]
        prefill = D.make_prefill_step(c, mesh, (), S + n_new)
        decode = D.make_decode_step(c, mesh, ())
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        with (OpCost(mesh) if tally is not None else nullcontext()) as cost:
            logits, cache = prefill(local, toks)
        if tally is not None:
            tally.update(cost.result())
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        steps = [logits]
        t0 = time.perf_counter()
        for i in range(n_new - 1):
            lg, cache = decode(local, cache, steps[-1].argmax(-1), S + i)
            steps.append(lg)
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t0) * 1e3 / max(n_new - 1, 1)
        return torch.stack(steps, 1), pre_ms, dec_ms

    def one_device(c, seed_w, toks, steps_of, fp32=False):
        """The one-device prefill and decode on the whole weights (with
        ``fp32``, upcast and run in fp32), fed the tokens ``steps_of``
        picked."""
        whole = layered_params(c, seed_w)
        if fp32:
            c = dataclasses.replace(c, dtype="float32")
            whole = tree_map(lambda x: x.float(), whole)
        model = Model(c)
        n = steps_of.shape[1]
        with torch.no_grad():
            lg, cache = model.prefill(whole, toks,
                                      max_len=toks.shape[1] + n)
            ref = [lg]
            for i in range(n - 1):
                lg, cache = model.decode(whole, cache,
                                         steps_of[:, i].argmax(-1),
                                         toks.shape[1] + i)
                ref.append(lg)
        del whole, cache
        return torch.stack(ref, 1)

    place = _placer(cfg, mesh)
    local = _one_rank_at_a_time(
        mesh, lambda: layered_params(cfg, seed + 10, place))
    # the warm-up's prefill is tallied (roofline.op_cost: its collectives,
    # which [dryrun] holds the dry-run's to)
    tally = {}
    if flash:
        # warm-up; its first flash call's q / k / v are the rank's layer 0
        q, k, v, kw = _first_flash_call(
            lambda: run(cfg, local, tokens, 2, tally))
        out["flash"] = _flash_on_rank(q, k, v, kw)
        del q, k, v
    else:
        run(cfg, local, tokens, 2, tally)
    out["prefill_tally"] = tally
    torch.cuda.reset_peak_memory_stats()
    reset_counters(counters)
    logits, pre_ms, dec_ms = run(cfg, local, tokens, new)
    counts = {k: f.launches for k, f in counters.items() if f.launches}
    routes = dict(fa.flash_attention_cuda.routes)
    want = {"flash_attention": flash} if flash else {}
    if counts != want or routes != {"cuda_cores": 0, "tensor_cores": flash}:
        raise AssertionError(f"[tp] rank {rank} serve {arch}: launches "
                             f"{counts}, routes {routes}, not {flash} "
                             "flash_attention on the tensor-core route")
    if logits.shape != (B, new, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[tp] rank {rank} {arch}: the served logits "
                             "are not finite full-vocab rows")
    out.update(prefill_ms=pre_ms, decode_ms=dec_ms, counts=counts,
               routes=routes, heads=_rank_heads(cfg, local),
               local_gb=sum(x.numel() * x.element_size()
                            for x in tree_leaves(local)) / 1e9,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    whole_gb = out["local_gb"] * int(shape[-1])
    del local
    torch.cuda.empty_cache()
    if rank == 0 and whole_gb < 45:
        # the one-device path on the same weights, fed the same tokens
        ref = one_device(cfg, seed + 10, tokens, logits)
        out["vs_one_device"] = dict(
            max_abs=float((logits - ref).abs().max()),
            top1=_top1(logits, ref))
        if top1_min is not None:
            f32 = one_device(cfg, seed + 10, tokens, logits, fp32=True)
            out["vs_fp32"] = dict(one_device=_top1(ref, f32),
                                  mesh=_top1(logits, f32))
            del f32
        del ref
        torch.cuda.empty_cache()
        print(f"[tp]   {arch} bf16 at m = {shape[-1]} vs one device: "
              f"{out['vs_one_device']}"
              + (f"; top-1 against one device in fp32: {out['vs_fp32']}"
                 if "vs_fp32" in out else ""), flush=True)
    del logits

    small = dataclasses.replace(cfg, n_layers=gate_layers, dtype="float32")
    gate_toks = tokens[:, :gate_s] if gate_s else tokens
    local = _one_rank_at_a_time(mesh, lambda: layered_params(
        small, seed + 20, _placer(small, mesh)))
    got, _, _ = run(small, local, gate_toks, 2)
    del local
    torch.cuda.empty_cache()
    ok = torch.tensor([1.0], device=dev)
    if rank == 0:
        want = one_device(small, seed + 20, gate_toks, got)
        d = float((got - want).abs().max())
        out["fp32_gate"] = d
        if not torch.allclose(got, want, rtol=TP_SERVE_TOL,
                              atol=TP_SERVE_TOL):
            ok.zero_()
        del want
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    if not ok.item():
        raise AssertionError(
            f"[tp] fp32 serve {arch} at {gate_layers} layers: max|d| "
            f"{out.get('fp32_gate')} against the one-device prefill / "
            f"decode, beyond {TP_SERVE_TOL}")
    out["gate_layers"], out["gate_s"] = gate_layers, gate_toks.shape[1]
    torch.cuda.empty_cache()
    return out


def _tp_ep(rank, shape, seed) -> dict:
    """(e) of ``phase_tp`` on one rank: TP_EP_ARCH at full width and
    TP_EP_LAYERS layers, bf16, ``moe_sharding='expert'`` (a rank holds
    E/m whole experts), the loss's forward logits and gradient on a
    TP_EP_B x TP_EP_S batch against the one-device ragged path on the
    same weights (rank 0), with the slots the capacity dropped
    (``moe.ep_stats``, the forward's); then fp32 at TP_EP_GATE_LAYERS
    layers and TP_EP_GATE_S tokens, where no slot can be dropped: logits
    and every gradient leaf within rtol / atol TP_SERVE_TOL."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_flatten, tree_leaves
    from repro_torch.fl import distributed as D
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import moe, sharding
    from repro_torch.models.model import Model

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_debug_mesh(shape)
    group = mesh.get_group("model")
    msize = int(shape[-1])
    base = dataclasses.replace(get_config(TP_EP_ARCH), moe_sharding="expert",
                               attn_impl="chunked")
    g = torch.Generator(device=dev).manual_seed(seed + 31)
    out = {}

    def case(c, seed_w, B, S):
        """(local logits, local grads, whole's logits and grads on rank 0
        else None, ep stats, ms of the sharded forward + gradient)."""
        toks = torch.randint(0, c.vocab_size, (B, S + 1), generator=g,
                             device=dev)
        batch = (toks[:, :-1], toks[:, 1:])
        model = Model(c)
        local = _one_rank_at_a_time(
            mesh, lambda: layered_params(c, seed_w, _placer(c, mesh)))
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        with sharding.model_parallel(group):
            moe.ep_stats_reset()
            with torch.no_grad():
                logits = model.forward(local, batch[0])[0]
            stats = moe.ep_stats()
            grads = torch.func.grad(model.loss)(local, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        specs = D.param_layout(c, mesh)
        del local
        torch.cuda.empty_cache()
        ref = None
        if rank == 0:
            whole = layered_params(c, seed_w)
            with torch.no_grad():
                ref_logits = model.forward(whole, batch[0])[0]
            ref_grads = torch.func.grad(model.loss)(whole, batch)
            del whole
            ref = (ref_logits, tree_leaves(ref_grads))
        return logits, tree_flatten(grads)[0], specs, ref, stats, ms

    def compare(grads, specs, ref, tol=None):
        """Each gradient leaf gathered in turn; on rank 0 its largest
        relative norm difference, and with ``tol`` whether all are
        within it.  Every rank learns the verdict."""
        worst, ok = 0.0, True
        for i, (x, spec) in enumerate(zip(grads, specs)):
            whole = sharding.gather_shard(x, spec, group, msize)
            if rank == 0:
                want = ref[1][i]
                worst = max(worst, float((whole.float() - want.float()).norm()
                                         / want.float().norm().clamp_min(
                                             1e-30)))
                if tol is not None and not torch.allclose(
                        whole, want, rtol=tol, atol=tol):
                    ok = False
            del whole
        flag = torch.tensor([1.0 if ok else 0.0], device=dev)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return worst, bool(flag.item())

    cfg = dataclasses.replace(base, n_layers=TP_EP_LAYERS)
    logits, grads, specs, ref, stats, ms = case(cfg, seed + 30, TP_EP_B,
                                                TP_EP_S)
    finite = torch.tensor([float(bool(torch.isfinite(logits).all()) and all(
        bool(torch.isfinite(x).all()) for x in grads))], device=dev)
    dist.all_reduce(finite, op=dist.ReduceOp.MIN)
    if not finite.item():
        raise AssertionError("[tp] (e) the expert-parallel logits or "
                             "gradient are not finite")
    worst, _ = compare(grads, specs, ref)
    out.update(layers=cfg.n_layers, experts=cfg.n_experts // msize,
               stats=stats, ms=ms, grad_rel=worst)
    if rank == 0:
        out.update(max_abs=float((logits.float() - ref[0].float()).abs()
                                 .max()),
                   top1=float((logits.argmax(-1) == ref[0].argmax(-1))
                              .float().mean()))
    del logits, grads, ref
    torch.cuda.empty_cache()

    small = dataclasses.replace(base, n_layers=TP_EP_GATE_LAYERS,
                                dtype="float32")
    logits, grads, specs, ref, stats, _ = case(small, seed + 40, 1,
                                               TP_EP_GATE_S)
    ok = torch.tensor([1.0], device=dev)
    if rank == 0:
        out["fp32_logits"] = float((logits - ref[0]).abs().max())
        if stats["dropped"] or not torch.allclose(
                logits, ref[0], rtol=TP_SERVE_TOL, atol=TP_SERVE_TOL):
            ok.zero_()
    dist.all_reduce(ok, op=dist.ReduceOp.MIN)
    worst, grads_ok = compare(grads, specs, ref, TP_SERVE_TOL)
    out.update(fp32_grad_rel=worst, fp32_stats=stats)
    if not (ok.item() and grads_ok):
        raise AssertionError(f"[tp] (e) fp32 expert-parallel at "
                             f"{TP_EP_GATE_LAYERS} layers: {out} against "
                             f"the one-device ragged path, beyond "
                             f"{TP_SERVE_TOL}")
    del logits, grads, ref
    torch.cuda.empty_cache()
    return out


def _tp_train(rank, shape, serve_shape, seed, counters) -> dict:
    """(g) of ``phase_tp`` on one rank: TP_TRAIN_ARCH trained federated on
    mesh ``shape`` (each client split over its 'model' ranks), bf16 at
    full width and TP_TRAIN_LAYERS layers, through ``make_train_step`` on
    each of TP_TRAIN_MIXINGS from the same init shards: ms a round, the
    launches counted from 0 ('fused': one aggregate a dtype group a round,
    on the rank's shard), GB a rank; each round's change from init
    against einsum's (``_change_sums`` on each rank's own shards,
    all-reduced: no rank gathers a whole tree).  Then fp32 on mesh
    ``serve_shape``: one client's loss and gradient
    (``torch.func.grad_and_value`` of ``Model.loss`` on the rank's shards)
    against the one-device path on the same weights, which rank 0 runs
    first and keeps on its card; the verdict all-reduced, read by
    ``phase_tp``."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.fl import distributed as D
    from repro_torch.fl import packing
    from repro_torch.launch.mesh import client_index, make_debug_mesh
    from repro_torch.models import sharding
    from repro_torch.models.model import Model

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_debug_mesh(shape)
    n = int(np.prod(shape[:-1]))
    cfg = lm_train_config(TP_TRAIN_ARCH, n_layers=TP_TRAIN_LAYERS)
    rng = np.random.default_rng(seed + 50)
    sampler = lm_train_data(cfg, seed + 50, TP_TRAIN_S, n=n)
    xs, ys = zip(*(sampler(rng, t) for t in range(LMT_ROUNDS)))
    toks = torch.cat([torch.stack(xs), torch.stack(ys)[..., -1:]],
                     dim=-1).to(dev)                  # (K, n, T, B, S+1)
    # one cluster of n clients, doubly stochastic A; round 0 samples
    # every client, later rounds one
    A = (0.5 * torch.eye(n) + 0.5 / n).expand(LMT_ROUNDS, n, n).to(dev)
    tau = torch.zeros(LMT_ROUNDS, n)
    tau[0] = 1.0
    for t in range(1, LMT_ROUNDS):
        tau[t, t % n] = 1.0
    m, tau = tau.sum(1).to(dev), tau.to(dev)
    eta = torch.full((LMT_ROUNDS,), LMT_ETA, device=dev)
    local = _one_rank_at_a_time(
        mesh, lambda: layered_params(cfg, seed + 50, _placer(cfg, mesh)))
    groups = packing.pack_spec(local).n_groups
    zlocal = D.shard_params(D.gather_params(local, cfg, mesh), cfg, mesh,
                            zero=True)
    torch.cuda.empty_cache()
    # the change from init is summed over each rank's own shards, each
    # value once: the clients hold equal copies, and a leaf the placement
    # keeps whole lies on every model rank
    mrank = int(mesh.get_local_rank("model"))
    counted = [client_index(mesh) == 0 and ("model" in spec or mrank == 0)
               for spec in D.param_layout(cfg, mesh)]
    out = {"layers": cfg.n_layers, "clients": n, "groups": groups,
           "tokens": n * LMT_T * TP_TRAIN_S}
    ref = []          # einsum's shards after each round, this rank's
    for mixing, zero in TP_TRAIN_MIXINGS:
        step = D.make_train_step(cfg, mesh, mixing=mixing, zero=zero)
        p = zlocal if zero else local
        ms = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(counters)
        for t in range(LMT_ROUNDS):
            dist.barrier()
            t0 = time.perf_counter()
            p = step(p, toks[t], A[t], tau[t], m[t], eta[t])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            mine = D.shard_params(D.gather_params(p, cfg, mesh, zero=True),
                                  cfg, mesh) if zero else p
            if mixing == "einsum":
                ref.append(mine)
                continue
            sums, maxes = _change_sums(mine, ref[t], local, dev, counted)
            sums = torch.tensor(sums, dtype=torch.float64, device=dev)
            maxes = torch.tensor(maxes, dtype=torch.float64, device=dev)
            dist.all_reduce(sums)
            dist.all_reduce(maxes, op=dist.ReduceOp.MAX)
            out[f"change/{mixing}/r{t}"] = _change_finish(sums.tolist(),
                                                          maxes.tolist())
            del mine
        counts = {k: f.launches for k, f in counters.items() if f.launches}
        want = {"aggregate": LMT_ROUNDS * groups} if mixing == "fused" \
            else {}
        if counts != want:
            raise AssertionError(f"[tp] (g) rank {rank} {mixing}: launches "
                                 f"{counts}, not {want}")
        out[mixing] = dict(
            ms=ms, counts=counts, zero=zero,
            local_gb=sum(x.numel() * x.element_size()
                         for x in tree_leaves(p)) / 1e9,
            peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del p, step
        torch.cuda.empty_cache()
    del local, zlocal, ref, toks
    torch.cuda.empty_cache()

    # fp32: one client's loss and gradient on serve_shape's model group
    mesh = make_debug_mesh(serve_shape)
    group = mesh.get_group("model")
    msize = int(serve_shape[-1])
    c32 = lm_train_config(TP_TRAIN_ARCH, n_layers=TP_TRAIN_LAYERS,
                          dtype="float32")
    model = Model(c32)
    g = torch.Generator(device=dev).manual_seed(seed + 51)
    tk = torch.randint(0, c32.vocab_size, (1, TP_TRAIN_GATE_S + 1),
                       generator=g, device=dev)
    batch = (tk[:, :-1], tk[:, 1:])
    want = None
    if rank == 0:
        # the one-device path first, its gradient kept on the card (21.6 GB
        # of fp32 at 1 + 1 layers) and its params freed
        torch.cuda.reset_peak_memory_stats()
        whole = layered_params(c32, seed + 52)
        grads, loss = torch.func.grad_and_value(model.loss)(whole, batch)
        del whole
        want = (float(loss), tree_leaves(grads))
        del grads, loss
        out["fp32_one_device_peak_gb"] = \
            torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.empty_cache()
    dist.barrier()
    local = _one_rank_at_a_time(
        mesh, lambda: layered_params(c32, seed + 52, _placer(c32, mesh)))
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    with sharding.model_parallel(group):
        grads, loss = torch.func.grad_and_value(model.loss)(local, batch)
    torch.cuda.synchronize()
    out["fp32_ms"] = (time.perf_counter() - t0) * 1e3
    del local
    ok, worst_abs, worst_rel = True, 0.0, 0.0
    if rank == 0:
        out["fp32_loss"] = (float(loss), want[0])
        ok = bool(torch.isclose(loss.cpu().double(),
                                torch.tensor(want[0], dtype=torch.float64),
                                **ORACLE_F32))
    for i, (x, spec) in enumerate(zip(tree_leaves(grads),
                                      D.param_layout(c32, mesh))):
        whole = sharding.gather_shard(x, spec, group, msize)
        if rank == 0:
            ref_i, want[1][i] = want[1][i], None
            d = (whole - ref_i).abs()
            worst_abs = max(worst_abs, float(d.max()))
            worst_rel = max(worst_rel, float(
                (whole - ref_i).norm() / ref_i.norm().clamp_min(1e-30)))
            ok = ok and bool(torch.isfinite(whole).all()) and \
                torch.allclose(whole, ref_i, **ORACLE_F32)
            del ref_i, d
        del whole
    del grads, loss
    flag = torch.tensor([1.0 if ok else 0.0], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    out.update(fp32_ok=bool(flag.item()), fp32_grad_max_abs=worst_abs,
               fp32_grad_rel=worst_rel, fp32_mesh=list(serve_shape),
               fp32_s=TP_TRAIN_GATE_S)
    torch.cuda.empty_cache()
    return out


def phase_tp(seed: int, shape=TP_SHAPE, backend=TP_BACKEND,
             zero: bool = False, serve_arch: str = TP_SERVE_ARCH,
             serve_shape=None, zoo=TP_ZOO) -> dict:
    """Tensor parallelism inside a client (``models/sharding.py``, the
    'model' axis of ``fl/distributed.py``): ``prod(shape)`` ranks spawned
    on the cards (rank r on card r % count; two on one card take gloo),
    mesh ``shape``.  (a) stablelm-1.6b bf16 at full width and depth
    (MESH_S tokens a step, LMT_T steps, LMT_ROUNDS
    rounds) on each of TP_CASES ('ring' with ``zero``; (f) 'ring' with
    sequence parallelism and the SP-MLP): every rank's launches counted
    from 0 ('fused': one aggregate a round on each rank, on its shard),
    scanned == sequential bitwise, ms a round, GB a rank; the gathered
    params' change from init after every round within TP_CHANGE_REL of
    LocalEngine's round function at the same n on the same inputs (what
    [mesh] holds its world-size-1 run to); fp32 pins at LMT_PIN_LAYERS
    layers and LMT_PIN_S tokens within rtol 2e-4 / atol 2e-5 of the
    one-rank round.  (b) ``serve_arch`` bf16, full width and depth, on
    mesh ``serve_shape`` (default ``shape``) through the mesh prefill /
    decode steps (``_tp_serve``); then the cases of ``zoo``: (c) / (d)
    TP_ZOO_SERVE the same way, (e) the expert-parallel MoE (``_tp_ep``)
    and (g) TP_TRAIN_ARCH trained federated (``_tp_train``; the
    four-card recipe).  Each rank
    counts its own launches (``kernel_counters`` in its process).
    Returns the launches of the main paths summed over the ranks:
    {"aggregate": .., "flash_attention": ..}."""
    import gc
    import os
    import tempfile
    import numpy as np
    import torch
    import torch.multiprocessing as mp

    # the ranks share the card with this process: it keeps nothing, and
    # theirs grow their segments in place (no block stranded between
    # one arch's tensors and the next's)
    gc.collect()
    torch.cuda.empty_cache()
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    serve_shape = tuple(serve_shape or shape)
    world = int(np.prod(shape))
    if int(np.prod(serve_shape)) != world:
        raise ValueError(f"serve mesh {serve_shape} is not {world} ranks")
    n = int(np.prod(shape[:-1]))
    cfg = lm_train_config()
    rng = np.random.default_rng(seed)
    sampler = lm_train_data(cfg, seed, MESH_S, n=n)
    xs, ys = zip(*(sampler(rng, t) for t in range(LMT_ROUNDS)))
    toks = torch.cat([torch.stack(xs), torch.stack(ys)[..., -1:]],
                     dim=-1)                       # (K, n, T, B, S+1)
    x32, y32 = lm_train_data(cfg, seed + 1, LMT_PIN_S, n=n)(rng, 0)
    cards = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.split("\n")
    cases = [_case_key(*c) for c in TP_CASES]
    print(f"[tp] {backend}, {world} ranks on {torch.cuda.device_count()} "
          f"card(s) ({'; '.join(c for c in cards if c)}); (a) / (f) mesh "
          f"{tuple(shape)}: {cfg.name} bf16 "
          f"{cfg.n_layers} layers, {n} client(s), T {LMT_T}, S {MESH_S}, "
          f"{LMT_ROUNDS} rounds a run on {cases}"
          f"{' (ring with zero)' if zero else ''}; (b) mesh {serve_shape}: "
          f"{serve_arch} bf16, {LM_BATCH}x{LM_SEQ} prompt, {LM_NEW} decode "
          "steps" + "".join(f"; ({c}) {a}" for c, a, *_ in TP_ZOO_SERVE
                            if c in zoo)
          + (f"; (e) {TP_EP_ARCH} expert-parallel" if "e" in zoo else "")
          + (f"; (g) {TP_TRAIN_ARCH} trained at {TP_TRAIN_LAYERS} layers on "
             f"mesh {tuple(shape)}, fp32 at {serve_shape}" if "g" in zoo
             else "")
          + f"; this process holds {torch.cuda.memory_allocated() / 1e9:.2f}"
          f" GB ({torch.cuda.memory_reserved() / 1e9:.2f} reserved)",
          flush=True)
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(toks=toks,
                        A=torch.eye(n).expand(LMT_ROUNDS, n, n).contiguous(),
                        tau=torch.ones(LMT_ROUNDS, n),
                        m=torch.full((LMT_ROUNDS,), float(n)),
                        eta=torch.full((LMT_ROUNDS,), LMT_ETA),
                        toks32=torch.cat([x32, y32[..., -1:]], dim=-1)),
                   Path(tmp) / "train.pt")    # A = I: one client a pod
        ctx = mp.start_processes(
            _tp_rank, args=(tmp, tuple(shape), backend, zero, serve_arch,
                            serve_shape, seed, zoo),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.time() + 3 * TP_TIMEOUT_S
        try:
            while not ctx.join(timeout=5):
                if time.time() > deadline:
                    raise AssertionError("[tp] the ranks did not finish")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                    proc.join()
            if alloc_conf is None:
                del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
            else:
                os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
        ranks = []
        for r in range(world):
            with open(Path(tmp) / f"rank{r}.json") as f:
                ranks.append(json.load(f))
    for key in cases:
        per = [x[key] for x in ranks]
        rel = [ranks[0][f"change/{key}/r{t}"]["rel"]
               for t in range(LMT_ROUNDS)]
        print(f"[tp] {key}{' zero' if zero and key == 'ring' else ''}"
              f": {max(x['ms'] for x in per):.1f} ms a round (slowest "
              f"rank), launches a rank "
              f"{[x['counts'] or 'none' for x in per]}; "
              + ("timed on the scanned run" if per[0]["seq_routes"] else
                 "scanned == sequential bitwise") + "; shards "
              f"{[round(x['local_gb'], 3) for x in per]} GB a rank, peak "
              f"{[round(x['peak_gb'], 2) for x in per]} GB; the change "
              f"off LocalEngine's (n = {n}) by "
              f"{' / '.join(f'{x:.4e}' for x in rel)} after rounds "
              f"{' / '.join(map(str, range(LMT_ROUNDS)))} "
              f"(gate {TP_CHANGE_REL}); fp32 pin ({LMT_PIN_LAYERS} "
              f"layers, S {LMT_PIN_S}) max|d| "
              f"{max(x[f'pin32/{key}'][0] for x in ranks):.3e}"
              + (f"; sequence collectives a rank by route "
                 f"{[x['seq_routes'] for x in per]}"
                 if per[0]["seq_routes"] else ""))
        moved = ranks[0][f"change/{key}/r{LMT_ROUNDS - 1}"]["moved"]
        if moved < MOVED_MIN or max(rel) > TP_CHANGE_REL:
            raise AssertionError(
                f"[tp] {key} vs LocalEngine: moved {moved:.3%}, the "
                f"change off by {rel} after each round, gate "
                f"{TP_CHANGE_REL}")
    flash, low = 0, []
    for arch, key in [(serve_arch, "serve")] + (
            [(a, f"serve/{a}") for c, a, *_ in TP_ZOO_SERVE if c in zoo]):
        sv = [x[key] for x in ranks]
        n_flash = sum(x["counts"].get("flash_attention", 0) for x in sv)
        flash += n_flash
        line = (f"[tp] serve {arch} at {sv[0]['layers']} layers: heads a "
                f"rank {sv[0]['heads']}; prefill {LM_BATCH}x{LM_SEQ} "
                f"{max(x['prefill_ms'] for x in sv):.1f} ms, decode "
                f"{max(x['decode_ms'] for x in sv):.2f} ms a step (slowest "
                f"rank); {n_flash} flash launches"
                f"{', all tensor-core' if n_flash else ''}; weights "
                f"{[round(x['local_gb'], 2) for x in sv]} GB a rank, peak "
                f"{[round(x['peak_gb'], 2) for x in sv]} GB")
        if "vs_one_device" in sv[0]:
            v = sv[0]["vs_one_device"]
            gate = sv[0]["top1_min"]
            m_serve = int(serve_shape[-1])
            line += (f"; vs one device: max|dlogits| {v['max_abs']:.3e}, "
                     f"top-1 agreement {v['top1']:.4%} "
                     + (f"(gate {gate})" if gate and m_serve < 4 else
                        "(not gated: m >= 4)" if gate else
                        "(not gated at bf16)"))
            f = sv[0].get("vs_fp32")
            if f is not None:
                line += (f"; top-1 against the one-device fp32 run of the "
                         f"same weights: one device bf16 "
                         f"{f['one_device']:.4%}, mesh bf16 {f['mesh']:.4%}"
                         + (f" (gate: mesh >= one device - "
                            f"{TP_TOP1_DELTA:.4f})" if gate and m_serve >= 4
                            else ""))
            if gate and top1_low(m_serve, v["top1"], f):
                low.append(f"{arch} {v['top1']:.4%}"
                           + (f" (against fp32: mesh {f['mesh']:.4%}, one "
                              f"device {f['one_device']:.4%})"
                              if m_serve >= 4 else ""))
        print(line)
        if "flash" in sv[0]:
            f = [x["flash"] for x in sv]
            print(f"[tp]   flash on each rank's layer-0 q / k / v "
                  f"{tuple(f[0]['shape'])} (B, Hq, Hkv, S, hd) "
                  f"{f[0]['dtype']}, route {f[0]['route']}: max|err| "
                  f"{[x['max_abs_err'] for x in f]} against "
                  f"flash_attention_ref (rtol = atol = {TP_FLASH_TOL})")
        print(f"[tp]   fp32 at {sv[0]['gate_layers']} layers, S "
              f"{sv[0]['gate_s']}: max|d| "
              f"{sv[0]['fp32_gate']:.3e} against the one-device prefill / "
              f"decode (rtol = atol = {TP_SERVE_TOL})")
    if "e" in zoo:
        e = ranks[0]["ep"]
        print(f"[tp] (e) {TP_EP_ARCH} at {e['layers']} layers, "
              f"moe_sharding='expert', {e['experts']} whole experts a "
              f"rank: forward + gradient {TP_EP_B}x{TP_EP_S} "
              f"{max(x['ep']['ms'] for x in ranks):.1f} ms (slowest rank); "
              f"slots dropped by the capacity {e['stats']['dropped']} of "
              f"{e['stats']['slots']} ({e['stats']['calls']} layers); vs "
              f"the one-device ragged path: max|dlogits| "
              f"{e['max_abs']:.3e}, top-1 {e['top1']:.4%}, gradient "
              f"max ||d|| / ||g|| over leaves {e['grad_rel']:.3e}; fp32 at "
              f"{TP_EP_GATE_LAYERS} layers, {TP_EP_GATE_S} tokens "
              f"({e['fp32_stats']['dropped']} dropped): logits max|d| "
              f"{e['fp32_logits']:.3e}, gradient max ||d|| / ||g|| "
              f"{e['fp32_grad_rel']:.3e} (rtol = atol = {TP_SERVE_TOL})")
    bad = _tp_train_report(ranks, shape) if "g" in zoo else []
    TP_PREFILL_TALLY[serve_arch] = ranks[0]["serve"]["prefill_tally"]
    print(f"[tp] phase {time.perf_counter() - t_phase:.1f} s")
    if bad:
        raise AssertionError("[tp] (g) " + "; ".join(bad))
    if low:
        rule = (f"below {TP_TOP1_MIN}" if serve_shape[-1] < 4 else
                f"more than {TP_TOP1_DELTA:.4f} under the one-device bf16 "
                "run's against fp32")
        raise AssertionError(f"[tp] bf16 top-1 at m = {serve_shape[-1]} "
                             f"{rule}: {', '.join(low)} (every fp32 gate "
                             "held)")
    return {"aggregate": sum(x["fused"]["counts"].get("aggregate", 0)
                             + x.get("train", {}).get("fused", {}).get(
                                 "counts", {}).get("aggregate", 0)
                             for x in ranks),
            "flash_attention": flash}


def _tp_train_report(ranks, shape) -> list:
    """(g)'s lines from the ranks' records; returns what failed its
    gates: 'fused' / 'ring' off einsum's change by more than CHANGE_REL
    after round 0 / the last, einsum moving under MOVED_MIN, the fp32
    loss or gradient off the one-device path."""
    tr = [x["train"] for x in ranks]
    r0, bad = tr[0], []
    for mixing, zero in TP_TRAIN_MIXINGS:
        per = [x[mixing] for x in tr]
        ms = [max(x["ms"][t] for x in per) for t in range(LMT_ROUNDS)]
        line = (f"[tp] (g) {TP_TRAIN_ARCH} at {r0['layers']} layers, mesh "
                f"{tuple(shape)} ({r0['clients']} clients), {mixing}"
                f"{' zero' if zero else ''}: round ms "
                f"{[round(x, 1) for x in ms]} (slowest rank), "
                f"{r0['tokens'] / (ms[-1] / 1e3):,.0f} tokens/s (last "
                f"round); launches a rank "
                f"{[x['counts'] or 'none' for x in per]} ({r0['groups']} "
                f"dtype groups); shards "
                f"{[round(x['local_gb'], 3) for x in per]} GB a rank, peak "
                f"{[round(x['peak_gb'], 2) for x in per]} GB")
        if mixing != "einsum":
            r = [r0[f"change/{mixing}/r{t}"] for t in range(LMT_ROUNDS)]
            line += (f"; einsum moved {r[0]['moved']:.3%} / "
                     f"{r[-1]['moved']:.3%} of values; the change off "
                     f"einsum's by ||d - d_einsum|| / ||d_einsum|| "
                     f"{r[0]['rel']:.4e} / {r[-1]['rel']:.4e} after rounds "
                     f"0 / {LMT_ROUNDS - 1} (gates {CHANGE_REL[0]} / "
                     f"{CHANGE_REL[1]}), {r[-1]['differ']:.4%} of values "
                     "differ")
            if r[0]["rel"] > CHANGE_REL[0] or r[-1]["rel"] > CHANGE_REL[1]:
                bad.append(f"{mixing} vs einsum: change off by "
                           f"{r[0]['rel']:.3e} / {r[-1]['rel']:.3e}")
            if min(r[0]["moved"], r[-1]["moved"]) < MOVED_MIN:
                bad.append(f"einsum moved {r[0]['moved']:.3%} / "
                           f"{r[-1]['moved']:.3%}, under {MOVED_MIN:.0%}")
        print(line)
    loss = r0["fp32_loss"]
    print(f"[tp] (g) fp32 at mesh {tuple(r0['fp32_mesh'])}, "
          f"{r0['layers']} layers, 1x{r0['fp32_s']} tokens: loss "
          f"{loss[0]:.6f} vs one device {loss[1]:.6f}; gradient max|d| "
          f"{r0['fp32_grad_max_abs']:.3e}, max ||d|| / ||g|| over leaves "
          f"{r0['fp32_grad_rel']:.3e} (rtol {ORACLE_F32['rtol']}, atol "
          f"{ORACLE_F32['atol']}): {'held' if r0['fp32_ok'] else 'FAILED'}"
          f"; the sharded loss + gradient {max(x['fp32_ms'] for x in tr):.1f}"
          f" ms (slowest rank); the one-device path peaked at "
          f"{r0['fp32_one_device_peak_gb']:.2f} GB on rank 0's card")
    if not r0["fp32_ok"]:
        bad.append("fp32 loss or gradient off the one-device path")
    return bad


# -- [ckpt] -----------------------------------------------------------------

CKPT_ROUNDS, CKPT_AT = 4, 2     # the paper cell's run, and where it stops
CKPT_FIXTURE = ROOT / "tests" / "data" / "ckpt_ref" / "ckpt_00000002.npz"


def phase_ckpt(seed: int, lm_params, counters) -> dict:
    """Checkpoints on the card (``repro_torch.ckpt``).  (1) The paper cell
    runs CKPT_ROUNDS rounds uninterrupted and again as CKPT_AT rounds,
    ``save_checkpoint`` of the card's params, ``load_checkpoint`` into a
    like tree on the card and ``plan[CKPT_AT:]`` from the restored
    params: on 'fused' (-> aggregate) and on 'sparse' with record_mixed
    (-> sparse_mix_aggregate), sequential and scanned; params bitwise
    equal, History records equal, each kernel launched once a round in
    the three runs.  (2) ``lm_params`` ([lmtrain]'s trained bf16 tree)
    round-trips bitwise through a checkpoint, write and read seconds and
    GB/s printed.  (3) The reference-written fixture under ``tests/data``
    loads on the card bitwise equal to the file's arrays.  Returns
    ({kernel: launches in (1)}, {kernel: their routes})."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.core.pytree import tree_flatten, tree_map
    from repro_torch.core.server import FederatedServer, ServerConfig
    from repro_torch.fl.engine import ExecutionConfig

    n, c, T, _, batcher, spec, loss_fn, init = paper_cell(seed)
    launches, routes = {}, {}

    def records(h):
        return [(r.t, r.m, r.m_actual, r.d2s, r.d2d, r.psi_bound, r.eta)
                for r in h.records]

    with tempfile.TemporaryDirectory() as tmp:
        for backend, record_mixed, kernel in (
                ("fused", False, "aggregate"),
                ("sparse", True, "sparse_mix_aggregate")):
            for scan in (False, True):
                server = FederatedServer(
                    spec.build(), loss_fn, init, batcher,
                    ServerConfig(T=T, t_max=CKPT_ROUNDS, seed=seed),
                    execution=ExecutionConfig(backend=backend, scan=scan,
                                              record_mixed=record_mixed))
                plan, batches = server._plan_and_batches()
                engine = server.engine
                reset_counters(counters)
                full, h_full = engine.execute(plan, init, batches)
                head, h_head = engine.execute(plan[:CKPT_AT], init,
                                              batches[:CKPT_AT])
                path = save_checkpoint(f"{tmp}/{backend}{scan}", CKPT_AT,
                                       head, meta={"t0": CKPT_AT})
                like = tree_map(torch.zeros_like, head)
                restored, meta = load_checkpoint(path, like)
                devs = {str(x.device) for x in tree_flatten(restored)[0]}
                tail, h_tail = engine.execute(plan[CKPT_AT:], restored,
                                              batches[CKPT_AT:])
                torch.cuda.synchronize()
                counts = {k: f.launches for k, f in counters.items()
                          if f.launches}
                groups = counts.get(kernel, 0) // (2 * CKPT_ROUNDS)
                if counts != {kernel: groups * 2 * CKPT_ROUNDS} or \
                        groups < 1:
                    raise AssertionError(f"[ckpt] {backend}: launches "
                                         f"{counts}")
                launches[kernel] = launches.get(kernel, 0) + counts[kernel]
                if hasattr(counters[kernel], "routes"):
                    got = dict(counters[kernel].routes)
                    if got != {"generic": 0, "staged": counts[kernel]}:
                        raise AssertionError(f"[ckpt] {kernel} routes {got}")
                    for r, k in got.items():
                        routes.setdefault(kernel, dict.fromkeys(got, 0))
                        routes[kernel][r] += k
                same = all(torch.equal(a, b) for a, b in zip(
                    tree_flatten(full)[0], tree_flatten(tail)[0]))
                hist_same = records(h_head) + records(h_tail) == \
                    records(h_full)
                print(f"[ckpt] paper cell on {backend}"
                      f"{' record_mixed' if record_mixed else ''} "
                      f"({'scanned' if scan else 'sequential'}): "
                      f"{CKPT_ROUNDS} rounds == {CKPT_AT} + checkpoint "
                      f"(restored on {sorted(devs)}, step "
                      f"{meta['step']}) + {CKPT_ROUNDS - CKPT_AT}: params "
                      f"bitwise {same}, History {hist_same}; "
                      f"{counts[kernel]} {kernel} launches")
                if not (same and hist_same and devs == {"cuda:0"}):
                    raise AssertionError(f"[ckpt] resume on {backend} "
                                         "differs from the uninterrupted run")
                del server, engine, full, head, tail, restored, like

        # (2) [lmtrain]'s trained bf16 params through a checkpoint
        leaves = tree_flatten(lm_params)[0]
        nbytes = sum(x.numel() * x.element_size() for x in leaves)
        dtypes = sorted({str(x.dtype) for x in leaves})
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(f"{tmp}/lm", 1, lm_params)
        w_s = time.perf_counter() - t0
        like = tree_map(torch.empty_like, lm_params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        back, _ = load_checkpoint(path, like)
        torch.cuda.synchronize()
        r_s = time.perf_counter() - t0
        same = all(a.dtype == b.dtype and a.device == b.device
                   and torch.equal(a.view(torch.int16), b.view(torch.int16))
                   for a, b in zip(tree_flatten(back)[0], leaves))
        print(f"[ckpt] [lmtrain]'s trained params: {len(leaves)} leaves, "
              f"{sum(x.numel() for x in leaves):,} values {dtypes}, "
              f"{nbytes / 1e9:.3f} GB: write {w_s:.2f} s "
              f"({nbytes / w_s / 1e9:.2f} GB/s, card -> host -> .npz), read "
              f"{r_s:.2f} s ({nbytes / r_s / 1e9:.2f} GB/s, .npz -> host -> "
              f"card); restored bitwise: {same}")
        if dtypes != ["torch.bfloat16"] or not same:
            raise AssertionError("[ckpt] the bf16 tree did not round-trip")
        del back, like

    # (3) the reference-written file, onto the card
    with np.load(CKPT_FIXTURE) as npz:
        arrays = {k: npz[k] for k in npz.files}
    like = {"head": [torch.zeros(arrays["head/0"].shape, device="cuda"),
                     torch.zeros(arrays["head/1"].shape, dtype=torch.int32,
                                 device="cuda")],
            "layer": {k: torch.zeros(arrays[f"layer/{k}"].shape,
                                     device="cuda") for k in ("b", "w")},
            "step_count": torch.zeros(arrays["step_count"].shape,
                                      dtype=torch.int32, device="cuda")}
    got, meta = load_checkpoint(str(CKPT_FIXTURE), like)
    from repro_torch.core.pytree import tree_flatten_with_paths
    same = all(str(x.device) == "cuda:0"
               and np.array_equal(x.cpu().numpy(), arrays[k])
               and x.cpu().numpy().dtype == arrays[k].dtype
               for k, x in tree_flatten_with_paths(got)[0])
    print(f"[ckpt] reference-written {CKPT_FIXTURE.relative_to(ROOT)} "
          f"({CKPT_FIXTURE.stat().st_size:,} bytes, keys {meta['keys']}): "
          f"on the card bitwise {same}")
    if not same:
        raise AssertionError("[ckpt] the reference's file did not load")
    return launches, routes


# -- [dryrun] -----------------------------------------------------------------

# the production combos [dryrun] runs (single pod, 256 fake ranks), in the
# background from the build on: every arch's decode_32k, long_500k and
# prefill_32k, and train_4k (T = 5) where it keeps the background within
# the script's time.  Host seconds a train_4k combo on the card's host
# (four at a time beside a training phase): internvl2-1b 49.9, qwen2-7b
# 51.4, qwen1.5-4b 67.8, musicgen-large 84.5 (run), phi3.5-moe 94.7,
# qwen3-32b 121.5, zamba2-2.7b 122.5, deepseek-v2 538.8 (left out: the
# background's ~208 s would pass the ~670 s the phases give it);
# deepseek-v2's prefill_32k 54.3
DRYRUN_COMBOS = (
    [(a, "train_4k") for a in ("stablelm-1.6b", "mamba2-1.3b",
                               "internvl2-1b", "qwen2-7b", "qwen1.5-4b",
                               "musicgen-large")]
    + [(a, s) for s in ("decode_32k", "long_500k", "prefill_32k")
       for a in ("qwen3-32b", "musicgen-large", "mamba2-1.3b",
                 "internvl2-1b", "zamba2-2.7b", "deepseek-v2-236b",
                 "phi3.5-moe-42b-a6.6b", "qwen1.5-4b", "qwen2-7b",
                 "stablelm-1.6b")])
DRYRUN_LOG = ROOT / "build" / "dryrun_torch.log"
DRYRUN_OUT = ROOT / "build" / "dryrun_torch"
DRYRUN_TIMEOUT_S = 900
# the card branch of a MoE (grouped_mm) on FakeTensorMode CUDA tensors
DRYRUN_CUDA_COMBO = ("phi3.5-moe-42b-a6.6b", "decode_32k")


def dryrun_start():
    """Start the production dry-runs (DRYRUN_COMBOS) in a background
    process on the host's CPU (meta stand-ins: it never touches the card),
    its lines into DRYRUN_LOG; ``phase_dryrun`` reads them."""
    import os
    code = ("import sys, time, traceback\n"
            "from repro_torch.launch import dryrun\n"
            "t0 = time.time(); bad = 0\n"
            f"for a, s in {DRYRUN_COMBOS!r}:\n"
            "    try:\n"
            f"        rec = dryrun.run_combo(a, s, out_dir={str(DRYRUN_OUT)!r})\n"
            "        print(dryrun.ok_line(rec), flush=True)\n"
            "    except Exception:\n"
            "        bad += 1\n"
            "        print(f'FAIL {a} {s}', flush=True)\n"
            "        traceback.print_exc(file=sys.stdout)\n"
            "print(f'TOTAL {time.time() - t0:.1f} s', flush=True)\n"
            "sys.exit(1 if bad else 0)\n")
    DRYRUN_LOG.parent.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    log = open(DRYRUN_LOG, "w")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)


def _dryrun_tp_prefill(arch: str, shape, batch: int, seq: int):
    """The dry-run's tally of [tp] (b)'s prefill step: rank 0 of a fake
    world of ``prod(shape)`` ranks, meta stand-ins, the same config, batch
    and sequence as ``_tp_serve``'s warm-up."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.fl import distributed as D
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.model import Model
    from repro_torch.roofline import cost_of

    world = 1
    for s in shape:
        world *= s
    dryrun.fake_world(world)
    try:
        mesh = make_debug_mesh(tuple(shape), device="cpu")
        cfg = dataclasses.replace(get_config(arch), attn_impl="flash")
        whole, specs = shapes.param_structs(Model(cfg, device="meta"), mesh)
        local = shapes._local(whole, specs, mesh, "meta")
        prefill = D.make_prefill_step(cfg, mesh, (), seq + 2)
        toks = torch.empty((batch, seq), dtype=torch.int64, device="meta")
        return cost_of(prefill, local, toks, mesh=mesh)
    finally:
        dist.destroy_process_group()


def phase_dryrun(proc, seed: int, tp_tally=None) -> None:
    """The dry-run (``launch/dryrun.py``, ``roofline``).  (1) The
    production combos ``dryrun_start`` ran in the background: every
    record's line, all OK; and DRYRUN_CUDA_COMBO here on FakeTensorMode
    CUDA stand-ins (the MoE's ``grouped_mm`` branch), its FLOPs and
    collectives equal to the meta run's.  (2) qwen2-7b's [lm] 'ref'
    forward (LM_BATCH x LM_SEQ, bf16, full size): the op_cost count on
    fake CUDA tensors equal to ``FlopCounterMode``'s around the real
    forward on the card, exactly; MemTracker's peak beside
    ``torch.cuda.max_memory_allocated``; the forward's ms (CUDA events)
    beside ``roofline_report``'s compute and memory seconds.  (3)
    ``tp_tally``, the collectives one rank of [tp] (b) tallied around its
    real qwen2-7b prefill, equal to the dry-run's of the same step."""
    import dataclasses
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves, tree_map
    from repro_torch.launch import dryrun
    from repro_torch.models.model import Model
    from repro_torch.roofline import OpCost, roofline_report

    # (1) the background combos
    try:
        rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    lines = DRYRUN_LOG.read_text().splitlines()
    for line in lines:
        if line.startswith(("OK", "FAIL", "TOTAL")):
            print(f"[dryrun] {line}")
    oks = [ln for ln in lines if ln.startswith("OK")]
    if rc != 0 or len(oks) != len(DRYRUN_COMBOS):
        print("\n".join(lines[-60:]))
        raise AssertionError(f"[dryrun] {len(oks)} of {len(DRYRUN_COMBOS)} "
                             f"combos OK (exit {rc})")
    arch, shape_name = DRYRUN_CUDA_COMBO
    try:
        rec = dryrun.run_combo(arch, shape_name, out_dir=str(DRYRUN_OUT),
                               tag="cuda", device="cuda")
    finally:
        dist.destroy_process_group()
    meta = json.loads((DRYRUN_OUT / f"{arch}__{shape_name}__16x16.json")
                      .read_text())
    same = all(rec[k] == meta[k] for k in (
        "flops_per_device", "collective_per_device", "collective_per_axis",
        "n_collective_ops"))
    print(f"[dryrun] {dryrun.ok_line(rec)} (FakeTensorMode on cuda, the "
          f"card's branches); FLOPs and collectives equal the meta run's: "
          f"{same}; bytes {rec['bytes_per_device']:.6e} vs "
          f"{meta['bytes_per_device']:.6e}")
    if not same:
        raise AssertionError("[dryrun] fake CUDA and meta counts differ")

    # (2) the [lm] 'ref' forward: fake count == the card's
    cfg = dataclasses.replace(get_config(LM_ARCH), attn_impl="ref")
    model = Model(cfg)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    params = model.init(g)
    tokens = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_SEQ),
                           generator=g, device=dev)
    with torch.no_grad():
        model.forward(params, tokens)                     # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with FlopCounterMode(display=False) as fc:
            model.forward(params, tokens)
        torch.cuda.synchronize()
        real_peak = torch.cuda.max_memory_allocated()
        real_flops = fc.get_total_flops()
        ms = cuda_ms(lambda: model.forward(params, tokens), iters=3,
                     warmup=1)
    mode = FakeTensorMode()
    with mode:
        fparams = tree_map(lambda x: torch.empty(
            x.shape, dtype=x.dtype, device=x.device), params)
        ftokens = torch.empty(tokens.shape, dtype=tokens.dtype, device=dev)
    del params
    torch.cuda.empty_cache()
    mem = MemTracker()
    mem.track_external(*tree_leaves(fparams), ftokens)
    with mode, torch.no_grad(), OpCost() as cost, mem:
        model.forward(fparams, ftokens)
    fake = cost.result()
    fake_peak = max(v.get("Total", 0) for v in
                    mem.get_tracker_snapshot("peak").values())
    rep = roofline_report(arch=LM_ARCH, shape=f"{LM_BATCH}x{LM_SEQ}",
                          mesh="1", chips=1, flops_global=fake["flops"],
                          bytes_global=fake["bytes"], collectives=fake,
                          cfg=cfg, kind="prefill",
                          tokens=LM_BATCH * LM_SEQ)
    print(f"[dryrun] {LM_ARCH} 'ref' forward {LM_BATCH}x{LM_SEQ} bf16: "
          f"FLOPs on fake CUDA tensors {fake['flops']:.6e}, "
          f"FlopCounterMode around the card's forward {real_flops:.6e}: "
          f"equal {fake['flops'] == real_flops}; peak MemTracker (fake) "
          f"{fake_peak / 1e9:.3f} GB vs torch.cuda.max_memory_allocated "
          f"{real_peak / 1e9:.3f} GB; measured {ms:.2f} ms vs roofline "
          f"(H100 published peaks) compute {rep.compute_s * 1e3:.2f} ms, "
          f"memory {rep.memory_s * 1e3:.2f} ms ({fake['bytes']:.4e} bytes "
          f"in the ideal-fusion model): {rep.dominant}-bound, "
          f"{max(rep.compute_s, rep.memory_s) * 1e3 / ms:.1%} of the "
          f"larger term")
    if fake["flops"] != real_flops or real_flops <= 0:
        raise AssertionError("[dryrun] the fake FLOP count is not the "
                             "card's")
    del fparams, mode
    torch.cuda.empty_cache()

    # (3) [tp] (b)'s prefill: the rank's collectives == the dry-run's
    if tp_tally is None:
        raise AssertionError("[dryrun] [tp] (b) left no prefill tally")
    dry = _dryrun_tp_prefill(TP_SERVE_ARCH, TP_SHAPE, LM_BATCH, LM_SEQ)
    keys = ("collectives", "collectives_by_axis", "collective_ops")
    same = all(dry[k] == tp_tally[k] for k in keys)
    print(f"[dryrun] [tp] (b) {TP_SERVE_ARCH} prefill at mesh {TP_SHAPE}: "
          f"rank 0's real run tallied {tp_tally['collective_ops']} "
          f"ops, {tp_tally['collectives']} bytes by kind, "
          f"{tp_tally['collectives_by_axis']} by axis; the dry-run "
          f"{dry['collective_ops']}, {dry['collectives']}, "
          f"{dry['collectives_by_axis']}: equal {same}")
    if not same:
        raise AssertionError("[dryrun] the dry-run's collectives are not "
                             "the real prefill's")


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
    t0 = time.perf_counter()

    def lap(what):
        print(f"[time] {what} done, {time.perf_counter() - t0:.1f} s since "
              "the build began", flush=True)

    phase_build()
    lap("[build]")
    dry = dryrun_start()
    try:
        return _phases(name, lap, dry)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()


def _phases(name, lap, dry) -> int:
    import torch
    rows = phase_kernels(70, 1_663_488)
    rows += phase_sparse_kernels(SEED)
    rows += phase_quant_kernels(SEED)
    phase_gemv(SEED)
    lap("[kernels] [sparse] [quant] [gemv]")
    rows.append(phase_flash(SEED))
    rows.append(phase_flash_bwd(SEED))
    launches, routes = phase_train(ROUNDS, SEED)
    control_launches, control_routes = phase_control(ROUNDS, SEED)
    for kernel, count in control_launches.items():
        launches[kernel] += count
    for kernel, by_route in control_routes.items():
        for r, count in by_route.items():
            routes[kernel][r] += count
    phase_hetero(SEED)
    lap("[flash] [train] [control] [hetero]")
    launches["aggregate"] += phase_quickstart(kernel_counters())
    launches["aggregate_dequant"] += phase_paper(kernel_counters())
    lap("[quickstart] [paper]")
    launches["aggregate"] += phase_stream(STREAM_ROUNDS, SEED)
    launches["aggregate"] += phase_ingest(STREAM_ROUNDS, SEED)
    phase_scale(SEED)
    lap("[stream] [ingest] [scale]")
    launches["flash_attention"] = phase_lm(SEED, kernel_counters())
    launches["flash_attention"] += phase_zoo(SEED, kernel_counters())
    launches["flash_attention_bwd"] = 0       # the training phases' below
    phase_serve(SEED, kernel_counters())
    lap("[lm] [zoo] [serve]")
    trained = {}
    lm_launches, lm_rows = phase_lmtrain(SEED, kernel_counters(), trained)
    for kernel, count in lm_launches.items():
        launches[kernel] += count
    routes["mix_aggregate"]["staged"] += lm_launches["mix_aggregate"]
    ckpt_launches, ckpt_routes = phase_ckpt(SEED, trained.pop("params"),
                                            kernel_counters())
    for kernel, count in ckpt_launches.items():
        launches[kernel] += count
    for kernel, by_route in ckpt_routes.items():
        for r, count in by_route.items():
            routes[kernel][r] += count
    torch.cuda.empty_cache()
    lap("[lmtrain] [ckpt]")
    moe_launches, moe_rows = phase_moetrain(SEED, kernel_counters())
    for kernel, count in moe_launches.items():
        launches[kernel] += count
    routes["mix_aggregate"]["staged"] += moe_launches["mix_aggregate"]
    torch.cuda.empty_cache()
    lap("[moetrain]")
    zoo_launches, zoo_rows = phase_zootrain(SEED, kernel_counters())
    for kernel, count in zoo_launches.items():
        launches[kernel] += count
    routes["mix_aggregate"]["staged"] += zoo_launches["mix_aggregate"]
    torch.cuda.empty_cache()
    lap("[zootrain]")
    launches["aggregate"] += phase_mesh(SEED, kernel_counters())
    lap("[mesh]")
    for kernel, count in phase_tp(SEED).items():
        launches[kernel] += count
    lap("[tp]")
    phase_dryrun(dry, SEED, TP_PREFILL_TALLY.get(TP_SERVE_ARCH))
    lap("[dryrun]")
    for row in rows:
        if row["name"] in lm_rows:
            row["lm_payload"] = lm_rows[row["name"]]
            row["moe_payload"] = moe_rows[row["name"]]
            for arch, by_kernel in zoo_rows.items():
                row[f"{arch.split('-')[0]}_payload"] = by_kernel[row["name"]]
        row["launches"] = launches[row["name"]]
        if row["name"] in routes:
            row["routes"] = routes[row["name"]]
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
