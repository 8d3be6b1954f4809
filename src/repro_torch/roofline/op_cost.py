"""Operation-level FLOP / byte / collective tally of one run of a
function (the port's counterpart of ``repro.roofline.jaxpr_cost`` and
``repro.roofline.hlo_walk``).

The reference walks the jaxpr of a traced step for FLOPs and bytes
(``jaxpr_cost``: scan bodies times their trip counts) and the compiled
HLO's call graph for collective bytes (``hlo_walk``).  PyTorch has no
traced program to walk: ``cost_of`` runs the function -- on
``FakeTensorMode`` stand-ins, which allocate nothing, or on real tensors
-- under a dispatch mode that sees every aten and c10d op it executes.
Python loops run unrolled, so every trip is counted and no loop has an
unknown trip count (``unknown_while`` is always 0); backward passes and
remat recomputation (``models.remat``) are counted like any other work,
as in the reference.

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` (matmuls,
  convolutions, attention), plus ``aten._grouped_mm`` (the MoE's grouped
  GEMM, which the registry lacks) at 2 x rows x K x N, the reference's
  ``ragged_dot`` count: any split of the rows over the experts gives it.
* Bytes: the reference's ideal-fusion HBM model (``jaxpr_cost``):
  operand + result bytes of products and convolutions, gathers,
  scatters, index ops, sorts, reductions, cumulative sums,
  concatenations and top-k (``BYTES_OPS``); elementwise ops and views
  are assumed fused and are not counted.
* Collectives: the result bytes of every c10d op the port's helpers
  run (``fl/distributed.py``, ``models/sharding.py``), by kind and by
  mesh axis (the mesh dims the op's group spans, e.g. 'model' or
  'pod,data'), and the number of ops by kind.  Kinds use the reference's
  names where one exists ('all-reduce', 'all-gather', 'reduce-scatter',
  'all-to-all'); the port adds 'broadcast' and 'recv' (a ring hop's
  receive: the reference's 'collective-permute').  A send has no result:
  it is counted in ``collective_ops`` only, and its bytes arrive as the
  peer's recv.

Every figure is this rank's (per device); the reference's are global.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["OpCost", "cost_of", "BYTES_OPS", "COLLECTIVE_KINDS"]

# aten ops whose operand + result bytes count (jaxpr_cost's _BYTES_PRIMS
# and its products), by class
BYTES_OPS: Dict[str, str] = {}
for _cls, _names in {
    "product": ("mm", "addmm", "bmm", "baddbmm", "addbmm", "mv", "addmv",
                "dot", "vdot", "_grouped_mm", "_scaled_mm", "convolution",
                "convolution_backward",
                "_scaled_dot_product_efficient_attention",
                "_scaled_dot_product_efficient_attention_backward",
                "_scaled_dot_product_flash_attention",
                "_scaled_dot_product_flash_attention_backward",
                "_scaled_dot_product_cudnn_attention",
                "_scaled_dot_product_cudnn_attention_backward"),
    "gather": ("index", "index_select", "gather", "take", "embedding",
               "embedding_dense_backward", "masked_select"),
    "scatter": ("index_put", "index_put_", "_index_put_impl_", "index_add",
                "index_add_", "index_copy", "index_copy_", "scatter",
                "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
                "scatter_reduce_", "slice_scatter", "select_scatter",
                "diagonal_scatter", "masked_scatter"),
    "sort": ("sort", "topk"),
    "reduce": ("sum", "mean", "amax", "amin", "max", "min", "argmax",
               "argmin", "any", "all", "prod", "logsumexp", "_softmax",
               "_log_softmax", "_softmax_backward_data",
               "_log_softmax_backward_data", "linalg_vector_norm", "var",
               "std", "var_mean", "std_mean", "nll_loss_forward",
               "nll_loss_backward", "cumsum", "cumprod", "logcumsumexp"),
    "concat": ("cat", "stack"),
}.items():
    for _n in _names:
        BYTES_OPS["aten::" + _n] = _cls
# max / min are reductions only in these overloads (max.other is
# elementwise)
_REDUCING_OVERLOADS = {"aten::max": ("default", "dim", "dim_max"),
                       "aten::min": ("default", "dim", "dim_min")}

# c10d op -> kind; its result is its first argument (a tensor or a list,
# or list of lists, of them), a send's its payload
COLLECTIVE_KINDS: Dict[str, str] = {
    "c10d::allreduce_": "all-reduce",
    "c10d::allreduce_coalesced_": "all-reduce",
    "c10d::allgather_": "all-gather",
    "c10d::_allgather_base_": "all-gather",
    "c10d::allgather_coalesced_": "all-gather",
    "c10d::allgather_into_tensor_coalesced_": "all-gather",
    "c10d::reduce_scatter_": "reduce-scatter",
    "c10d::_reduce_scatter_base_": "reduce-scatter",
    "c10d::reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "c10d::alltoall_": "all-to-all",
    "c10d::alltoall_base_": "all-to-all",
    "c10d::broadcast_": "broadcast",
    "c10d::reduce_": "reduce",
    "c10d::gather_": "gather",
    "c10d::scatter_": "scatter",
    "c10d::recv_": "recv",
    "c10d::recv_any_source_": "recv",
    "c10d::send": "send",
}


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


def _nbytes(x) -> int:
    """The bytes a tensor's elements span, a broadcast (stride-0) dim
    counted once: an operand expanded for a batched product is read
    once, whichever way ``matmul`` folded it."""
    total = 0
    for t in _tensors(x):
        n = 1
        for size, stride in zip(t.shape, t.stride()):
            n *= size if stride else min(size, 1)
        total += n * t.element_size()
    return total


def _grouped_mm_flop(a_shape, b_shape, *args, out_shape=None, **kwargs):
    """2 x (rows) x K x N summed over the groups: a 2-D x 2-D product
    (groups along K, the weight gradient) sums K once over every output
    element of a group; any other layout reads a's last dim K for every
    output element."""
    if len(a_shape) == 2 and len(b_shape) == 2:
        return 2 * out_shape[-2] * out_shape[-1] * a_shape[1]
    return 2 * math.prod(out_shape) * a_shape[-1]


def _flop_mapping():
    return {torch.ops.aten._grouped_mm: _grouped_mm_flop}


class _Tally(TorchDispatchMode):
    def __init__(self, cost: "OpCost"):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.cost._observe(func, args, kwargs, out)
        return out


class OpCost:
    """``with OpCost(mesh) as c: fn(...)`` -> ``c.result()``: FLOPs,
    bytes and collectives of what ran inside (module docstring).
    ``mesh`` (a ``DeviceMesh``) names each collective's axis; without
    one a group is named by its size ('ranks=8')."""

    def __init__(self, mesh=None):
        self.mesh = mesh
        self.bytes = 0
        self.by_class: Dict[str, int] = {}
        self.collectives: Dict[str, int] = {}
        self.collectives_by_axis: Dict[str, int] = {}
        self.collective_ops: Dict[str, int] = {}
        self._axis_of: Dict[str, str] = {}
        self._coords = None
        self._flops = None

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        if self.mesh is not None and self._coords is None:
            from torch._subclasses.fake_tensor import unset_fake_temporarily
            with unset_fake_temporarily():
                grid = self.mesh.mesh.tolist()
            self._coords = {}
            self._index(grid, ())
        self._flops = FlopCounterMode(display=False,
                                      custom_mapping=_flop_mapping())
        self._flops.__enter__()
        self._mode = _Tally(self)
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._flops.__exit__(*exc)
        return False

    def _index(self, grid, at) -> None:
        if isinstance(grid, list):
            for i, g in enumerate(grid):
                self._index(g, at + (i,))
        else:
            self._coords[int(grid)] = at

    def _axis(self, group) -> str:
        name = group.group_name
        if name not in self._axis_of:
            ranks = dist.get_process_group_ranks(group)
            if self._coords is None or any(r not in self._coords
                                           for r in ranks):
                label = f"ranks={len(ranks)}"
            else:
                dims = self.mesh.mesh_dim_names
                label = ",".join(
                    dims[d] for d in range(len(dims))
                    if len({self._coords[r][d] for r in ranks}) > 1) \
                    or "self"
            self._axis_of[name] = label
        return self._axis_of[name]

    def _observe(self, func, args, kwargs, out) -> None:
        name = func._schema.name
        kind = COLLECTIVE_KINDS.get(name)
        if kind is not None:
            self.collective_ops[kind] = self.collective_ops.get(kind, 0) + 1
            if kind == "send":
                return
            group = None
            for a in args:
                if isinstance(a, torch.ScriptObject):
                    try:
                        group = dist.ProcessGroup.unbox(a)
                        break
                    except RuntimeError:    # a ReduceOp, not a group
                        continue
            nb = _nbytes(args[0])
            self.collectives[kind] = self.collectives.get(kind, 0) + nb
            axis = self._axis(group)
            self.collectives_by_axis[axis] = \
                self.collectives_by_axis.get(axis, 0) + nb
            return
        cls = BYTES_OPS.get(name)
        if cls is None or (name in _REDUCING_OVERLOADS and
                           func._overloadname
                           not in _REDUCING_OVERLOADS[name]):
            return
        nb = _nbytes(args) + _nbytes(kwargs) + _nbytes(out)
        self.bytes += nb
        self.by_class[cls] = self.by_class.get(cls, 0) + nb

    @property
    def flops(self) -> int:
        return int(self._flops.get_total_flops()) if self._flops else 0

    def result(self) -> Dict[str, Any]:
        """The reference's ``jaxpr_cost`` keys (``flops``, ``bytes``,
        ``unknown_while``; this rank's) plus ``bytes_by_class``,
        ``collectives`` (result bytes by kind), ``collectives_by_axis``
        and ``collective_ops`` (ops by kind)."""
        return {"flops": float(self.flops), "bytes": float(self.bytes),
                "unknown_while": 0,
                "bytes_by_class": dict(self.by_class),
                "collectives": dict(self.collectives),
                "collectives_by_axis": dict(self.collectives_by_axis),
                "collective_ops": dict(self.collective_ops)}


def cost_of(fn, *args, mesh=None, **kwargs) -> Dict[str, Any]:
    """Run ``fn(*args, **kwargs)`` once under ``OpCost(mesh)`` and return
    its tally (``OpCost.result``).  Give it ``FakeTensorMode`` inputs (and
    call it inside that mode) to count without allocating."""
    with OpCost(mesh) as c:
        fn(*args, **kwargs)
    return c.result()
