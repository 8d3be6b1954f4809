"""Mesh-distributed semi-decentralized FL round (Algorithm 1) and the
sharded inference steps on ``torch.distributed`` (port of
``repro.fl.distributed``).

Mapping, as in the reference: client i = one (pod, data) mesh index,
``i = pod * n_data + data`` (``repro_torch.launch.mesh``); a D2D cluster
is one pod; the 'model' axis carries tensor parallelism inside every
client (``models.sharding``).  ``A`` (block-diagonal over pods for the
'ring' and 'gather' schedules, which only mix inside a pod), ``tau``,
``m``, ``eta`` and ``active`` are runtime inputs, so one step serves
every round of Algorithm 1, FedAvg (A = I) and COLREL.

Every rank runs the same program (SPMD).  It holds its shards of the
global params (``shard_params``: the slices of its 'model' index, the
whole leaves at a 'model' axis of 1) and reads its own client's tokens,
runs its T local SGD steps (``core.rounds.local_sgd``: ``torch.func.grad``
of ``Model.loss``) with the model group's collectives, and joins the
collectives of one mixing schedule over the clients of its own 'model'
index -- the ranks that hold the same shards.  The reference's
``client_impl`` 'vmap' (GSPMD batching of the client axis) and
'shardmap' (one client a shard) are the same computation at one client
a rank, so both run that.  The schedules (``_mix_and_aggregate``) move
the rank's delta as its packed per-dtype rows (``fl.packing``), one
collective a dtype group:

  'einsum'   -- ``all_gather`` every client's row, then the single-host
                oracle's fp32 ``A @ X`` and ``tau @ mixed / m`` on every
                rank (``core.rounds.mix_deltas`` / ``global_update``).
  'gather'   -- ``all_gather`` over 'data' inside the pod, then the pod
                block of the rank's row of A, in the deltas' dtype.
  'ring'     -- ``n_data`` hops of ``batch_isend_irecv`` around the pod,
                accumulating ``a_ij X_j`` in the reference's order.
  'fused'    -- ``all_gather`` the packed rows, then one ``aggregate``
                kernel launch a dtype group for ``w @ X`` with
                ``w = combine_weights(A, tau, m, active)``; with ``quant``
                the stored containers and scales travel and
                ``aggregate_dequant`` computes the row.
  'fused_rs' -- ``w_i X_i`` on the rank's own row, ``reduce_scatter``
                over 'data', ``all_reduce`` over 'pod', and the
                ``all_gather`` of the shards over 'data' that the
                reference leaves to GSPMD (``pack_spec(shards=n_data)``);
                with ``quant`` each rank dequantizes only its own row.

D2S arithmetic is the reference's: 'ring' and 'gather' reduce
``tau_i * mixed_i`` in the deltas' dtype (an ``all_reduce``) and divide
by m in fp32; the materializing schedules zero dropped clients' rows,
the one-pass ones fold ``active`` into ``w``.  An all-ones ``active`` is
bitwise ``None``.  Quantized payloads ('fused' / 'fused_rs') keep each
rank's own error-feedback residual ``(1, P_pad_g)`` of its own shards;
stochastic rounding seeds a rank's generator with its client index too
(``packing.quantize_packed(client=)``).

``zero=True`` ('ring' only, as in the reference): the global copy keeps
1/n_data of each leaf along its first unsharded dim that 'data' divides
(``zero_specs``); an ``all_gather`` over 'data' starts the round, and the
D2S reduce-scatters each such leaf over 'data' and all-reduces it over
'pod' before the fp32 ``/ m``.

``make_prefill_step`` / ``make_decode_step`` run ``Model.prefill`` /
``decode`` on a rank's rows of the batch (``batch_rows`` over
``batch_axes``) and its shards of the weights; the logits come back
full-vocab and the cache holds the rank's rows and what its layers read:
its kv heads, the whole MLA latent ring, its SSD heads and conv
channels.

Collectives run on the mesh's process groups: gloo ranks on the CPU,
NCCL ranks one card each, or gloo ranks sharing a card (gloo takes CUDA
tensors for ``all_reduce`` and ``broadcast``; a one-rank group's gather
is the row itself).  fp8 containers travel as their bytes; every other
row in its own dtype, and sums run in the payload's own dtype.

At a 'model' axis above 1 every family runs on its shards
(``models.sharding``): attention, MLA, the SSD and hybrid stacks, the
MLP and both MoE layouts (tensor-parallel experts, or whole experts a
rank with ``moe_sharding='expert'``); sequence parallelism and the
SP-MLP follow ``sharding.set_activation_sharding``, as in the reference,
which reaches them through its global settings too.
"""

from __future__ import annotations

import weakref
from typing import Any, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.adjacency import network_matrix
from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.core.rounds import global_update, local_sgd, \
    mask_clients, mix_deltas
from repro_torch.kernels.mixing.ops import aggregate_grouped, \
    aggregate_grouped_q, combine_weights
from repro_torch.launch.mesh import (client_axes, client_index,
                                     data_axis_size, model_axis_size,
                                     n_clients_of)
from repro_torch.models import sharding
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from . import packing

PyTree = Any

__all__ = ["make_train_step", "make_scanned_train_steps",
           "make_prefill_step", "make_decode_step",
           "build_topology_inputs", "init_rank_quant_state",
           "mesh_device", "zero_specs", "param_layout", "shard_params",
           "gather_params", "batch_rows", "MIXINGS"]

MIXINGS = ("ring", "gather", "einsum", "fused", "fused_rs")


def mesh_device(mesh) -> torch.device:
    """This rank's device: the CPU for a gloo mesh on the CPU, its
    current card otherwise; on a dry-run's fake process group
    (``launch/dryrun.py``) card 0, without touching CUDA."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    if "fake" in str(dist.get_backend()):
        return torch.device(mesh.device_type, 0)
    return torch.device(mesh.device_type, torch.cuda.current_device())


def zero_specs(specs: PyTree, params: PyTree, data_size: int) -> PyTree:
    """ZeRO-style global-parameter sharding: 'data' on each leaf's first
    dim that is unsharded, divisible by ``data_size`` and at least as
    large (the reference's rule; a spec tree in, a spec tree out)."""
    def one(spec, leaf):
        for i, s in enumerate(spec):
            if s is None and leaf.shape[i] % data_size == 0 \
                    and leaf.shape[i] >= data_size:
                return spec[:i] + ("data",) + spec[i + 1:]
        return spec

    leaves, treedef = tree_flatten(params)
    return tree_unflatten(treedef, [one(s, x) for s, x in
                                    zip(sharding.spec_leaves(specs), leaves)])


def param_layout(cfg: ModelConfig, mesh, zero: bool = False) -> List[Tuple]:
    """The spec of each leaf of ``Model(cfg)``'s params on ``mesh``, in
    ``tree_flatten`` order: 'model' on the dim a rank holds a slice of
    (``sharding.placement_specs``), and with ``zero`` 'data' on the dim
    the global copy is split over.  The shapes come from an init under
    ``FakeTensorMode`` (no storage)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        whole = Model(cfg, device="cpu").init(torch.Generator())
    specs = sharding.placement_specs(whole, cfg, model_axis_size(mesh))
    if zero:
        specs = zero_specs(specs, whole, data_axis_size(mesh))
    return sharding.spec_leaves(specs)


def _data_rank(mesh) -> int:
    return int(mesh.get_local_rank(client_axes(mesh)[-1]))


def _model_rank(mesh) -> int:
    return int(mesh.get_local_rank("model"))


def shard_params(params: PyTree, cfg: ModelConfig, mesh,
                 zero: bool = False) -> PyTree:
    """The whole global params -> this rank's shards, the layout the
    train step takes (``param_layout``); the params themselves at a
    'model' axis of 1 without ``zero``."""
    msize = model_axis_size(mesh)
    if msize == 1 and not zero:
        return params
    leaves, treedef = tree_flatten(params)
    out = []
    for x, spec in zip(leaves, param_layout(cfg, mesh, zero)):
        x = sharding.local_shard(x, spec, _model_rank(mesh), msize)
        if "data" in spec:
            x = x.chunk(data_axis_size(mesh), spec.index("data"))[
                _data_rank(mesh)].contiguous()
        out.append(x)
    return tree_unflatten(treedef, out)


def gather_params(local: PyTree, cfg: ModelConfig, mesh,
                  zero: bool = False) -> PyTree:
    """Inverse of ``shard_params``: the whole tree, equal on every rank,
    bit for bit."""
    msize = model_axis_size(mesh)
    if msize == 1 and not zero:
        return local
    leaves, treedef = tree_flatten(local)
    model_group = mesh.get_group("model") if msize > 1 else None
    out = []
    for x, spec in zip(leaves, param_layout(cfg, mesh, zero)):
        if "data" in spec:
            x = _all_gather_dim(x, spec.index("data"),
                                mesh.get_group(client_axes(mesh)[-1]),
                                data_axis_size(mesh))
        out.append(sharding.gather_shard(x, spec, model_group, msize))
    return tree_unflatten(treedef, out)


def batch_rows(mesh, batch_axes, batch: int) -> slice:
    """The rows of a ``batch``-row batch this rank serves: the batch split
    evenly over ``batch_axes`` (an axis name or a tuple of them,
    outermost first; None: every rank serves every row), ranks that share
    their indices there serving the same rows."""
    axes = () if batch_axes is None else (batch_axes,) \
        if isinstance(batch_axes, str) else tuple(batch_axes)
    idx, size = 0, 1
    for a in axes:
        n = int(mesh.shape[mesh.mesh_dim_names.index(a)])
        idx, size = idx * n + int(mesh.get_local_rank(a)), size * n
    if batch % size:
        raise ValueError(f"a batch of {batch} rows does not split over "
                         f"{axes} ({size} ways)")
    rows = batch // size
    return slice(idx * rows, (idx + 1) * rows)


# the clients of each 'model' index, one group each, made once a mesh:
# every rank must create every group, in the same order
_CLIENT_GROUPS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _clients_group(mesh):
    """The group of the ranks that hold the same shards as this one (its
    'model' index), client order."""
    if mesh not in _CLIENT_GROUPS:
        ranks = mesh.mesh.reshape(-1, model_axis_size(mesh))
        _CLIENT_GROUPS[mesh] = [dist.new_group(ranks[:, j].tolist())
                                for j in range(ranks.shape[1])]
    return _CLIENT_GROUPS[mesh][_model_rank(mesh)]


class _Axes:
    """The process groups and this rank's place on the mesh."""

    def __init__(self, mesh):
        axes = client_axes(mesh)
        self.n = n_clients_of(mesh)
        self.n_data = data_axis_size(mesh)
        self.me = client_index(mesh)
        self.pod = self.me // self.n_data
        self.data = self.me % self.n_data
        self.msize = model_axis_size(mesh)
        self.data_group = mesh.get_group(axes[-1])
        self.pod_group = mesh.get_group(axes[0]) if len(axes) > 1 else None
        if dist.get_world_size() != self.n * self.msize:
            raise ValueError(
                f"the mesh has {self.n * self.msize} ranks but the process "
                f"group {dist.get_world_size()}: build it over the whole "
                "group")
        # at a 'model' axis of 1 the clients are the ranks of the default
        # group (group None), rank i being client i
        self.clients = None
        self.model_group = None
        if self.msize > 1:
            self.clients = _clients_group(mesh)
            self.model_group = mesh.get_group("model")


# fp8 containers travel as their bytes (not every backend gathers fp8)
_WIRE = {torch.float8_e4m3fn: torch.uint8}


def _all_gather_rows(row: torch.Tensor, group, size: int) -> torch.Tensor:
    """(1, P) -> (size, P), rows in group-rank order, bit for bit."""
    if size == 1:
        return row
    wire = _WIRE.get(row.dtype)
    send = (row if wire is None else row.view(wire)).contiguous()
    out = torch.empty((size,) + tuple(send.shape[1:]), dtype=send.dtype,
                      device=send.device)
    dist.all_gather_into_tensor(out, send, group=group)
    return out if wire is None else out.view(row.dtype)


def _all_gather_dim(x: torch.Tensor, dim: int, group, size: int
                    ) -> torch.Tensor:
    """The group's slices of a leaf, concatenated along ``dim``."""
    rows = _all_gather_rows(x.movedim(dim, 0).reshape(1, -1), group, size)
    whole = rows.reshape((size * x.shape[dim],)
                         + tuple(x.movedim(dim, 0).shape[1:]))
    return whole.movedim(0, dim).contiguous()


def _reduce_scatter_dim(x: torch.Tensor, dim: int, group, size: int
                        ) -> torch.Tensor:
    """The sum over the group of ``x``, this rank's slice along ``dim``."""
    front = x.movedim(dim, 0).contiguous()
    part = front.new_empty((front.shape[0] // size,) + front.shape[1:])
    dist.reduce_scatter_tensor(part, front, group=group)
    return part.movedim(0, dim)


def _own_rows(delta: PyTree, **spec_kw):
    """The rank's delta as packed (1, P_pad_g) rows and their spec."""
    tree = tree_map(lambda d: d[None], delta)
    spec = packing.pack_spec(tree, **spec_kw)
    return spec, packing.pack(tree, spec)


def _quantize_own(bufs, spec, qstate, client):
    """The client-side quantizer step on the rank's own rows (the mesh
    twin of ``core.rounds._quantize_deltas``)."""
    quant = spec.quant
    residuals, (seed, counter) = qstate
    key = None
    if quant.rounding == "stochastic":
        key, counter = (seed, counter), counter + 1
    stored, scales, new_res = packing.quantize_packed(
        bufs, spec, residuals if quant.error_feedback else None, key,
        client=client)
    new_qstate = ((new_res if quant.error_feedback else residuals),
                  (seed, counter))
    return stored, scales, new_qstate


def _permute_ring(row: torch.Tensor, ax: _Axes) -> torch.Tensor:
    """One ring hop inside the pod: send to data + 1, receive from
    data - 1 (the reference's ``ppermute`` perm)."""
    wire = _WIRE.get(row.dtype)
    send = (row if wire is None else row.view(wire)).contiguous()
    recv = torch.empty_like(send)
    nxt = dist.get_global_rank(ax.data_group, (ax.data + 1) % ax.n_data)
    prv = dist.get_global_rank(ax.data_group, (ax.data - 1) % ax.n_data)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, nxt, group=ax.data_group),
        dist.P2POp(dist.irecv, recv, prv, group=ax.data_group)])
    for r in reqs:
        r.wait()
    return recv if wire is None else recv.view(row.dtype)


def _zero_aggregate(ax: _Axes, contrib_rows, spec, global_params: PyTree,
                    zero_dims: List[int], m: torch.Tensor) -> PyTree:
    """ZeRO D2S: each leaf of ``tau_i * mixed_i`` (unpacked from the
    rows) reduce-scattered over 'data' along its zero dim and all-reduced
    over 'pod', added in fp32 ``/ m`` to the rank's slice of the global
    leaf; a leaf without one all-reduced over the clients."""
    contrib = tree_flatten(packing.unpack_row(contrib_rows, spec))[0]
    gl, treedef = tree_flatten(global_params)
    out = []
    for g, c, zd in zip(gl, contrib, zero_dims):
        if zd >= 0:
            part = _reduce_scatter_dim(c, zd, ax.data_group, ax.n_data)
            if ax.pod_group is not None:
                part = part.contiguous()
                dist.all_reduce(part, group=ax.pod_group)
        else:
            part = c.contiguous()
            dist.all_reduce(part, group=ax.clients)
        out.append((g + part.float() / m).to(g.dtype))
    return tree_unflatten(treedef, out)


def _mix_and_aggregate(ax: _Axes, mixing: str, delta: PyTree,
                       A: torch.Tensor, tau: torch.Tensor, m: torch.Tensor,
                       global_params: PyTree,
                       active: Optional[torch.Tensor] = None,
                       quant=None, qstate=None, zero_dims=None):
    """new_global = global + (1/m) sum_i tau_i (A @ deltas)_i, from this
    rank's ``delta`` (no client axis; the rank's shards) and the
    collectives of ``mixing`` over the clients of its 'model' index.
    With ``quant`` returns ``(new_global, new_qstate)``; ``zero_dims``
    (ring only): the ZeRO split dim of each global leaf, -1 for none."""
    i = ax.me
    if mixing == "einsum":
        spec, bufs = _own_rows(delta)
        X = packing.unpack(tuple(_all_gather_rows(b, ax.clients, ax.n)
                                 for b in bufs), spec)
        if active is not None:
            X = mask_clients(X, active)
            tau = tau * active
        return global_update(global_params, mix_deltas(A, X), tau, m)

    if mixing == "fused":
        if quant is not None:
            spec, bufs = _own_rows(delta, quant=quant)
            stored, scales, new_qstate = _quantize_own(bufs, spec, qstate,
                                                       i)
            stored = tuple(_all_gather_rows(s, ax.clients, ax.n)
                           for s in stored)
            scales = tuple(_all_gather_rows(s, ax.clients, ax.n)
                           for s in scales)
            rows = aggregate_grouped_q(A, tau, m, stored, scales,
                                       quant=quant, active=active)
            return (packing.apply_aggregate_row(global_params, rows, spec),
                    new_qstate)
        spec, bufs = _own_rows(delta)
        X = tuple(_all_gather_rows(b, ax.clients, ax.n) for b in bufs)
        rows = aggregate_grouped(A, tau, m, X, active=active)
        return packing.apply_aggregate_row(global_params, rows, spec)

    if mixing == "fused_rs":
        w = combine_weights(A, tau, m, active)
        if quant is not None:
            spec, bufs = _own_rows(delta, shards=ax.n_data, quant=quant)
            stored, scales, new_qstate = _quantize_own(bufs, spec, qstate,
                                                       i)
            own = [packing.dequantize_group(s, sc, quant)[0]
                   for s, sc in zip(stored, scales)]
        else:
            spec, bufs = _own_rows(delta, shards=ax.n_data)
            own = [b[0].float() for b in bufs]
        rows = []
        for x in own:
            contrib = w[i] * x
            part = contrib.new_empty(contrib.shape[0] // ax.n_data)
            dist.reduce_scatter_tensor(part, contrib, group=ax.data_group)
            if ax.pod_group is not None:
                dist.all_reduce(part, group=ax.pod_group)
            rows.append(_all_gather_rows(part[None], ax.data_group,
                                         ax.n_data).reshape(-1))
        new = packing.apply_aggregate_row(global_params, rows, spec)
        return new if quant is None else (new, new_qstate)

    # the materializing schedules: ring / gather, in the deltas' dtype
    spec, bufs = _own_rows(delta)
    if active is not None:
        bufs = tuple(mask_clients(list(bufs), active[i:i + 1]))
        tau = tau * active
    start = ax.pod * ax.n_data
    mixed = []
    for b in bufs:
        if mixing == "ring":
            recv, acc = b, torch.zeros_like(b)
            for r in range(ax.n_data):
                j = start + (ax.data - r) % ax.n_data
                acc = acc + A[i, j].to(b.dtype) * recv
                if r + 1 < ax.n_data:      # the last hop's result is unused
                    recv = _permute_ring(recv, ax)
            mixed.append(acc[0])
        else:   # 'gather'
            pod_rows = _all_gather_rows(b, ax.data_group, ax.n_data)
            arow = A[i, start:start + ax.n_data]
            mixed.append(arow.to(b.dtype) @ pod_rows)
    contribs = [tau[i].to(x.dtype) * x for x in mixed]
    if zero_dims is not None:
        return _zero_aggregate(ax, contribs, spec, global_params, zero_dims,
                               m)
    rows = []
    for contrib in contribs:
        dist.all_reduce(contrib, group=ax.clients)
        rows.append(contrib.float() / m)
    return packing.apply_aggregate_row(global_params, rows, spec)


def make_train_step(cfg: ModelConfig, mesh, mixing: str = "ring",
                    zero: bool = False, client_impl: str = "vmap",
                    quant=None):
    """Build ``train_step(global_params, tokens, A, tau, m, eta[, prefix]
    [, active][, qstate])`` on this rank.

    global_params: this rank's shards of the global params
    (``shard_params(params, cfg, mesh, zero)``; the whole tree at a
    'model' axis of 1 without ``zero``), on ``mesh_device(mesh)``, equal
    on the ranks of one 'model' index; the new global params come back in
    the same layout, so rounds compose (``gather_params`` gives the whole
    tree).  tokens: (n_clients, T, B_local, S+1) int -- every client's
    per-step minibatches, inputs and targets adjacent slices; the rank
    reads its own client's row.  prefix (audio/vlm): (n_clients, T,
    B_local, P, fdim).  active: optional (n,) 0/1 straggler mask.

    ``quant`` (a ``packing.QuantSpec``; 'fused' / 'fused_rs' only): the
    step takes this rank's ``qstate`` (``init_rank_quant_state``) and
    returns ``(new_global, new_qstate)``.  ``zero`` ('ring' only): the
    global params are also split over 'data' (module docstring).

    ``client_impl``: the reference's 'vmap' and 'shardmap' are the same
    step here, one client a rank run by hand.  The reference needs
    'shardmap' to nest its manual 'model'-axis collectives (the SP-MLP,
    the expert-parallel MoE) in the client step; the port runs them in
    either, reached through the same global settings
    (``sharding.set_activation_sharding``, ``set_moe_sharding``) and
    ``cfg.moe_sharding``."""
    if mixing not in MIXINGS:
        raise ValueError(f"mixing must be one of {MIXINGS}")
    if zero and mixing != "ring":
        raise ValueError("zero sharding is implemented for ring mixing")
    if client_impl not in ("vmap", "shardmap"):
        raise ValueError("client_impl must be 'vmap' or 'shardmap'")
    if quant is not None and mixing not in ("fused", "fused_rs"):
        raise ValueError(
            "quantized payloads on the mesh runtime require the one-pass "
            f"'fused' or 'fused_rs' schedules, got {mixing!r}")
    ax = _Axes(mesh)
    model = Model(cfg, device=mesh_device(mesh))
    zero_dims = None
    if zero:
        zero_dims = [s.index("data") if "data" in s else -1
                     for s in param_layout(cfg, mesh, zero=True)]

    def train_step(global_params, tokens, A, tau, m, eta, prefix=None,
                   active=None, qstate=None):
        if quant is not None and qstate is None:
            raise ValueError(
                "quantized train_step needs the quantizer state: build "
                "it with init_rank_quant_state and thread the returned "
                "new_qstate into the next step")
        tk = tokens[ax.me]
        batches = (tk[..., :-1], tk[..., 1:])
        if prefix is not None:
            batches = batches + (prefix[ax.me],)
        start = global_params
        if zero:
            # the round starts from the whole (model-local) global params
            leaves, treedef = tree_flatten(global_params)
            start = tree_unflatten(treedef, [
                x if zd < 0 else _all_gather_dim(x, zd, ax.data_group,
                                                 ax.n_data)
                for x, zd in zip(leaves, zero_dims)])
        with sharding.model_parallel(ax.model_group):
            final = local_sgd(model.loss, start, batches, eta)
        delta = tree_map(lambda f, g: f - g, final, start)
        del final, start
        return _mix_and_aggregate(ax, mixing, delta, A, tau, m,
                                  global_params, active=active,
                                  quant=quant, qstate=qstate,
                                  zero_dims=zero_dims)

    return train_step


def make_scanned_train_steps(cfg: ModelConfig, mesh, K: int,
                             mixing: str = "ring", zero: bool = False,
                             client_impl: str = "vmap", quant=None):
    """K mesh train steps over stacked inputs, as
    ``core.rounds.make_scanned_rounds`` runs K single-host rounds:

    ``scanned(global_params, tokens_seq, A_seq, tau_seq, m_seq, eta_seq[,
    prefix_seq][, active_seq][, qstate]) -> (final_params, params_seq[,
    final_qstate])``, params_seq leaves (K, ...) in the step's layout.
    The loop body is ``make_train_step``'s step on row t of each input,
    so the trajectory is bitwise K sequential steps."""
    step = make_train_step(cfg, mesh, mixing=mixing, zero=zero,
                           client_impl=client_impl, quant=quant)

    def scanned(global_params, tokens_seq, A_seq, tau_seq, m_seq, eta_seq,
                prefix_seq=None, active_seq=None, qstate=None):
        params, seq = global_params, []
        for t in range(K):
            kw = dict(
                prefix=None if prefix_seq is None else prefix_seq[t],
                active=None if active_seq is None else active_seq[t])
            out = step(params, tokens_seq[t], A_seq[t], tau_seq[t],
                       m_seq[t], eta_seq[t], qstate=qstate, **kw)
            params, qstate = out if quant is not None else (out, None)
            seq.append(params)
        params_seq = tree_map(lambda *xs: torch.stack(xs), *seq)
        if quant is not None:
            return params, params_seq, qstate
        return params, params_seq

    return scanned


def init_rank_quant_state(params: PyTree, quant, mesh, mixing: str):
    """This rank's round-0 quantizer state for its shards ``params`` (the
    train step's layout): zero residuals for its own client's packed
    rows, ``(1, P_pad_g)`` (``pack_spec(shards=n_data)`` on 'fused_rs'),
    and the key, counter 0."""
    shards = data_axis_size(mesh) if mixing == "fused_rs" else 1
    spec = packing.pack_spec(
        tree_map(lambda p: torch.empty((1,) + tuple(p.shape),
                                       dtype=p.dtype, device="meta"),
                 params), shards=shards, quant=quant)
    return packing.init_quant_state(spec, 1, mesh_device(mesh))


def _serve_setup(cfg: ModelConfig, mesh):
    model = Model(cfg, device=mesh_device(mesh))
    group = mesh.get_group("model") if model_axis_size(mesh) > 1 else None
    return model, group


def make_prefill_step(cfg: ModelConfig, mesh, batch_axes, cache_len: int):
    """``prefill_step(params, tokens[, prefix]) -> (logits, cache)``.

    params: this rank's shards (``shard_params``); tokens (B, K) [, prefix
    (B, P, fdim)]: the whole batch, of which the rank runs its rows
    ``batch_rows(mesh, batch_axes, B)``.  Returns those rows' last-position
    logits, full-vocab fp32 (B_rank, V), and their decode cache (ring of
    ``cache_len``) on the rank's kv heads.  GQA attends through the flash
    kernel where ``cfg.attn_impl`` is 'flash'."""
    model, group = _serve_setup(cfg, mesh)
    flash = cfg.attn_impl == "flash"

    def prefill_step(params, tokens, prefix=None):
        rows = batch_rows(mesh, batch_axes, tokens.shape[0])
        with torch.no_grad(), sharding.model_parallel(group):
            return model.prefill(
                params, tokens[rows],
                None if prefix is None else prefix[rows],
                max_len=cache_len, flash=flash)

    return prefill_step


def make_decode_step(cfg: ModelConfig, mesh, batch_axes,
                     donate_cache: bool = True):
    """``decode_step(params, cache, token, pos) -> (logits, cache)``:
    token (B,) the whole batch's, of which the rank decodes its rows
    (``batch_rows``) against its ``cache`` (``make_prefill_step``'s);
    logits full-vocab fp32 (B_rank, V).  ``donate_cache`` (default): the
    cache is updated in place and returned; otherwise a copy is."""
    model, group = _serve_setup(cfg, mesh)

    def decode_step(params, cache, token, pos):
        if not donate_cache:
            cache = tree_map(torch.clone, cache)
        rows = batch_rows(mesh, batch_axes, token.shape[0])
        with torch.no_grad(), sharding.model_parallel(group):
            return model.decode(params, cache, token[rows], pos)

    return decode_step


def build_topology_inputs(network, rng: np.random.Generator,
                          tau_idx: Optional[np.ndarray] = None,
                          t: int = 0) -> Tuple[np.ndarray, Any]:
    """Sample G(t) and return (A, clusters) ready to feed the mesh step;
    client order is the mesh's (pod-major).  Pass the round index ``t``
    so time-correlated topology families advance."""
    from .plan import _sample_snapshot
    clusters = _sample_snapshot(network, rng, t)
    A = network_matrix(clusters, network.n)
    return A.astype(np.float32), clusters
