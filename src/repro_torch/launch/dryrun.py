"""Dry-run: count one rank's step of every (arch x shape x mesh) combo
without a card or an allocation (port of ``repro.launch.dryrun``).

The reference lowers and compiles each step for 512 (or 256) forced host
devices and reads the compiled program's memory and cost analyses.
PyTorch has no such compile.  The port runs the step itself, as one rank
of the production world:

* a fake process group (``torch.distributed``'s "fake" backend: every
  collective returns at once, moving nothing) of the production world,
  256 ranks (512 with ``--multi-pod``; ``--mesh`` for a debug shape), as
  rank 0, 16 ranks a node;
* the mesh of ``launch/mesh.py`` (``make_production_mesh(node=16)``:
  (16, 16), or (2, 16, 16); ``make_debug_mesh``);
* one call of the port's own ``make_train_step`` / ``make_prefill_step``
  / ``make_decode_step`` (``fl/distributed.py``) on ``shapes.input_specs``
  (stand-ins without storage), under ``roofline.op_cost`` (FLOPs, bytes,
  collectives by kind and mesh axis) and
  ``torch.distributed._tools.mem_tracker.MemTracker`` (the run's peak);

and writes ``<out>/<arch>__<shape>__<mesh>[__tag].json`` with the
reference's record fields: ``roofline_report``'s (on an H100), ``mixing``,
``trace_s`` (the reference's ``compile_s``: the time of the abstract
run), ``total_s``, ``memory_analysis`` (argument bytes and the run's
peak, where the reference reports its compiled program's sizes),
``n_collective_ops`` and ``opts``; the reference's ``hlo_bytes`` has no
counterpart.

The stand-ins are ``meta`` tensors by default (``--device meta``): the
steps take their CPU branches (the MoE's per-expert loop, on an even
split of the rows, which gives the routed FLOPs), and each op costs
little.  ``--device cuda`` makes them ``FakeTensorMode`` tensors on the
card's device type, so the steps take their CUDA branches (the MoE's
``grouped_mm``) at ~4x the host time; a build of PyTorch without CUDA
cannot index a fake CUDA tensor.  FLOPs and collectives are the same
either way.  Every figure is rank 0's; FLOPs and bytes times the number
of ranks are the step's global totals (every rank runs the same
program).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all               # 40 single-pod
  python -m repro_torch.launch.dryrun --all --multi-pod   # 512 ranks
  python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
      --shape decode_32k --mesh 2,4 --out DIR

A failed combination prints ``FAIL`` and its traceback; the CLI exits 1
if any failed.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.configs import arch_names, get_config
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import shapes as shapes_lib
from repro_torch.roofline import OpCost, roofline_report

__all__ = ["DEFAULT_OUT", "NODE", "DEVICES", "fake_world", "lower_combo",
           "run_combo", "ok_line", "main"]

DEFAULT_OUT = "artifacts/dryrun_torch"
NODE = 16                       # ranks a node: the 'model' axis's domain
DEVICES = ("meta", "cuda")
# the fake backend for every device type a stand-in may sit on
FAKE_BACKEND = "cpu:fake,cuda:fake,meta:fake"


def fake_world(world: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a fake process group of
    ``world`` ranks (replacing any group it had)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() == FAKE_BACKEND \
                and dist.get_world_size() == world \
                and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=rank,
                            world_size=world)


def mesh_device_type(device: str) -> str:
    """The mesh's device type for stand-ins on ``device``: the card's for
    fake CUDA tensors, else the CPU's (meta tensors run the steps' CPU
    branches)."""
    return "cuda" if device == "cuda" else "cpu"


def _mesh_tag(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def _tokens_of(shape: shapes_lib.InputShape, T: int) -> int:
    if shape.kind == "train":
        return T * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return shape.global_batch * shape.seq_len
    return shape.global_batch          # decode: one token per sequence


def _leaves(tree):
    from repro_torch.core.pytree import tree_leaves
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def lower_combo(arch: str, shape_name: str, mesh, *, mixing: str = "ring",
                T: int = shapes_lib.DEFAULT_T, seq_shard: bool = False,
                loss_chunk: int = 0, moe_chunk: int = 0, attn_chunk: int = 0,
                moe_sharding: str = "", zero: bool = False,
                sp_mlp: bool = False, client_impl: str = "vmap",
                device: str = "meta") -> Dict[str, Any]:
    """Build one combination's step and inputs, run it once on the
    stand-ins and return its tally: ``cost`` (``OpCost.result``),
    ``peak_bytes`` (MemTracker's peak), ``arg_bytes`` (this rank's
    inputs), ``cfg``, ``shape``, ``trace_s``.

    Optimization knobs (all off = the paper-faithful baseline):
      seq_shard  -- sequence parallelism between blocks
      loss_chunk -- seq-chunked LM head + loss (no full fp32 logits)
      moe_chunk / attn_chunk / moe_sharding / zero / sp_mlp / client_impl
                 -- as the reference's
    """
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.fl import distributed as D
    from repro_torch.models import sharding

    shape = shapes_lib.SHAPES[shape_name]
    cfg = shapes_lib.production_config(get_config(arch), shape)
    changes = {k: v for k, v in (("loss_chunk", loss_chunk),
                                 ("moe_chunk", moe_chunk),
                                 ("attn_chunk", attn_chunk),
                                 ("moe_sharding", moe_sharding)) if v}
    if changes:
        cfg = dataclasses.replace(cfg, **changes)
    sharding.set_moe_sharding(moe_sharding or "tensor")
    sharding.set_activation_sharding("model" if seq_shard else None,
                                     sp_mlp=sp_mlp)
    try:
        if shape.kind == "train":
            inp = shapes_lib.train_inputs(cfg, shape, mesh, T=T, zero=zero,
                                          device=device)
            step = D.make_train_step(cfg, mesh, mixing=mixing, zero=zero,
                                     client_impl=client_impl)
            args = [inp["global_params"], inp["tokens"], inp["A"],
                    inp["tau"], inp["m"], inp["eta"]]
            if cfg.frontend:
                args.append(inp["prefix"])
        elif shape.kind == "prefill":
            inp = shapes_lib.prefill_inputs(cfg, shape, mesh, device=device)
            step = D.make_prefill_step(
                cfg, mesh, inp["_batch_axes"],
                cache_len=shapes_lib.cache_len_for(cfg, shape))
            args = [inp["params"], inp["tokens"]]
            if cfg.frontend:
                args.append(inp["prefix"])
        else:
            inp = shapes_lib.decode_inputs(cfg, shape, mesh, device=device)
            step = D.make_decode_step(cfg, mesh, inp["_batch_axes"])
            args = [inp["params"], inp["cache"], inp["token"], inp["pos"]]

        mem = MemTracker()
        mem.track_external(*_leaves(args))
        t0 = time.time()
        with inp["_mode"], OpCost(mesh) as cost, mem:
            step(*args)
        trace_s = time.time() - t0
        peak = mem.get_tracker_snapshot("peak")
    finally:
        sharding.set_activation_sharding(None)
        sharding.set_moe_sharding("tensor")
    peak_bytes = max((v.get("Total", 0) for v in peak.values()), default=0)
    return dict(cfg=cfg, shape=shape, cost=cost.result(),
                trace_s=trace_s, peak_bytes=float(peak_bytes),
                arg_bytes=float(sum(x.numel() * x.element_size()
                                    for x in _leaves(args))),
                device=device)


def run_combo(arch: str, shape_name: str, *, multi_pod: bool = False,
              mesh_shape=None, mixing: str = "ring",
              T: int = shapes_lib.DEFAULT_T, out_dir: str = DEFAULT_OUT,
              tag: str = "", seq_shard: bool = False, loss_chunk: int = 0,
              donate: bool = False, moe_chunk: int = 0,
              attn_chunk: int = 0, moe_sharding: str = "",
              zero: bool = False, sp_mlp: bool = False,
              client_impl: str = "vmap",
              device: str = "meta") -> Dict[str, Any]:
    """One combination on a fake world of the production size (or of
    ``mesh_shape``'s), rank 0; writes and returns its record.
    ``donate`` is recorded only: PyTorch has no buffer donation to ask
    for (the decode step updates its cache in place regardless)."""
    if mesh_shape is not None:
        world = 1
        for s in mesh_shape:
            world *= s
        fake_world(world)
        mesh = mesh_lib.make_debug_mesh(tuple(mesh_shape),
                                        device=mesh_device_type(device))
    else:
        fake_world(512 if multi_pod else 256)
        mesh = mesh_lib.make_production_mesh(
            multi_pod=multi_pod, node=NODE, device=mesh_device_type(device))
    t0 = time.time()
    meta = lower_combo(arch, shape_name, mesh, mixing=mixing, T=T,
                       seq_shard=seq_shard, loss_chunk=loss_chunk,
                       moe_chunk=moe_chunk, attn_chunk=attn_chunk,
                       moe_sharding=moe_sharding, zero=zero, sp_mlp=sp_mlp,
                       client_impl=client_impl, device=device)
    total_s = time.time() - t0

    shape = shapes_lib.SHAPES[shape_name]
    chips = dist.get_world_size()
    cost = meta["cost"]
    report = roofline_report(
        arch=arch, shape=shape_name, mesh=_mesh_tag(mesh), chips=chips,
        flops_global=cost["flops"] * chips,
        bytes_global=cost["bytes"] * chips, collectives=cost,
        cfg=meta["cfg"], kind=shape.kind, tokens=_tokens_of(shape, T),
        peak_memory=meta["peak_bytes"])

    record = report.as_dict()
    record.update(
        mixing=mixing if shape.kind == "train" else None,
        trace_s=meta["trace_s"], total_s=total_s,
        memory_analysis={"argument_size_in_bytes": meta["arg_bytes"],
                         "peak_bytes": meta["peak_bytes"]},
        n_collective_ops=int(sum(cost["collective_ops"].values())),
        collective_ops=cost["collective_ops"],
        bytes_by_class=cost["bytes_by_class"],
        device=meta["device"],
        opts=dict(seq_shard=seq_shard, loss_chunk=loss_chunk,
                  donate=donate, moe_chunk=moe_chunk,
                  attn_chunk=attn_chunk,
                  moe_sharding=moe_sharding or "tensor", zero=zero,
                  sp_mlp=sp_mlp, client_impl=client_impl),
    )
    os.makedirs(out_dir, exist_ok=True)
    name = f"{arch}__{shape_name}__{_mesh_tag(mesh)}"
    if tag:
        name += f"__{tag}"
    path = os.path.join(out_dir, name + ".json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1, default=str)
    record["_path"] = path
    return record


def ok_line(rec: Dict[str, Any]) -> str:
    coll = sum(rec["collective_per_device"].values())
    return (f"OK   {rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:9s} "
            f"flops/dev={rec['flops_per_device']:.3e} "
            f"coll/dev={coll:.3e}B "
            f"dom={rec['dominant']:10s} "
            f"trace={rec['trace_s']:.1f}s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", choices=arch_names())
    ap.add_argument("--shape", choices=shapes_lib.shape_names())
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) combination")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--mixing", default="ring",
                    choices=("ring", "gather", "einsum"))
    ap.add_argument("--T", type=int, default=shapes_lib.DEFAULT_T)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--tag", default="")
    ap.add_argument("--mesh", default="",
                    help="debug mesh, e.g. '2,2,2' (pod,data,model)")
    ap.add_argument("--device", default="meta", choices=DEVICES,
                    help="the stand-ins: meta tensors (default), or "
                    "FakeTensorMode tensors on cuda (the steps' card "
                    "branches; needs a CUDA build of PyTorch)")
    ap.add_argument("--seq-shard", action="store_true",
                    help="sequence parallelism between blocks")
    ap.add_argument("--loss-chunk", type=int, default=0,
                    help="seq-chunked LM head+loss")
    ap.add_argument("--donate", action="store_true",
                    help="recorded only: PyTorch has no donation")
    ap.add_argument("--moe-chunk", type=int, default=0,
                    help="token-chunked MoE dispatch")
    ap.add_argument("--attn-chunk", type=int, default=0,
                    help="override attention query-chunk")
    ap.add_argument("--moe-sharding", default="",
                    choices=("", "tensor", "expert"),
                    help="MoE weight layout")
    ap.add_argument("--zero", action="store_true",
                    help="ZeRO-style global param sharding")
    ap.add_argument("--sp-mlp", action="store_true",
                    help="explicit SP-MLP (needs --seq-shard)")
    ap.add_argument("--client-impl", default="vmap",
                    choices=("vmap", "shardmap"))
    args = ap.parse_args(argv)

    mesh_shape = None
    if args.mesh:
        mesh_shape = tuple(int(x) for x in args.mesh.split(","))

    if not args.all and (args.arch is None or args.shape is None):
        ap.error("--arch and --shape required (or --all)")
    combos = ([(a, s) for a in arch_names()
               for s in shapes_lib.shape_names()]
              if args.all else [(args.arch, args.shape)])

    failures = 0
    try:
        for arch, shape_name in combos:
            try:
                rec = run_combo(arch, shape_name, multi_pod=args.multi_pod,
                                mesh_shape=mesh_shape, mixing=args.mixing,
                                T=args.T, out_dir=args.out, tag=args.tag,
                                seq_shard=args.seq_shard,
                                loss_chunk=args.loss_chunk,
                                donate=args.donate,
                                moe_chunk=args.moe_chunk,
                                attn_chunk=args.attn_chunk,
                                moe_sharding=args.moe_sharding,
                                zero=args.zero, sp_mlp=args.sp_mlp,
                                client_impl=args.client_impl,
                                device=args.device)
                print(ok_line(rec), flush=True)
            except Exception:
                failures += 1
                print(f"FAIL {arch:22s} {shape_name:12s}", flush=True)
                traceback.print_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
