"""Mesh-distributed semi-decentralized FL round (Algorithm 1) on
``torch.distributed`` (port of ``repro.fl.distributed``, its data-parallel
half).

Mapping, as in the reference: client i = one (pod, data) mesh index,
``i = pod * n_data + data`` (``repro_torch.launch.mesh``); a D2D cluster
is one pod; ``A`` (block-diagonal over pods for the 'ring' and 'gather'
schedules, which only mix inside a pod), ``tau``, ``m``, ``eta`` and
``active`` are runtime inputs, so one step serves every round of
Algorithm 1, FedAvg (A = I) and COLREL.

Every rank runs the same program on its own client (SPMD): it holds the
replicated global params and its own client's tokens, runs its T local
SGD steps (``core.rounds.local_sgd``: ``torch.func.grad`` of
``Model.loss``), and joins the collectives of one mixing schedule.  The
reference's ``client_impl`` 'vmap' (GSPMD batching of the client axis)
and 'shardmap' (one client a shard) are the same computation at one
client a rank, so both run that.  The schedules (``_mix_and_aggregate``)
move the rank's delta as its packed per-dtype rows (``fl.packing``), one
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
rank's own error-feedback residual ``(1, P_pad_g)``; stochastic rounding
seeds a rank's generator with its client index too
(``packing.quantize_packed(client=)``).

Collectives run on the mesh's process groups: gloo ranks on the CPU,
NCCL ranks one card each.  fp8 containers travel as their bytes; every
other row in its own dtype, and sums run in the payload's own dtype.

Left for ROADMAP queue 1 item 13b, each a ``NotImplementedError``: a
'model' axis larger than 1 (tensor parallelism, ``models/sharding.py``),
``zero=True``, and the sharded inference steps ``make_prefill_step`` /
``make_decode_step`` (item 12(f)).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.adjacency import network_matrix
from repro_torch.core.pytree import tree_map
from repro_torch.core.rounds import global_update, local_sgd, \
    mask_clients, mix_deltas
from repro_torch.kernels.mixing.ops import aggregate_grouped, \
    aggregate_grouped_q, combine_weights
from repro_torch.launch.mesh import (client_axes, client_index,
                                     data_axis_size, model_axis_size,
                                     n_clients_of)
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from . import packing

PyTree = Any

__all__ = ["make_train_step", "make_scanned_train_steps",
           "make_prefill_step", "make_decode_step",
           "build_topology_inputs", "init_rank_quant_state", "check_mesh",
           "mesh_device", "MIXINGS"]

MIXINGS = ("ring", "gather", "einsum", "fused", "fused_rs")

_13B = "ROADMAP queue 1 item 13b"


def mesh_device(mesh) -> torch.device:
    """This rank's device: the CPU for a gloo mesh, its current card for
    an NCCL one."""
    if mesh.device_type == "cpu":
        return torch.device("cpu")
    return torch.device(mesh.device_type, torch.cuda.current_device())


def check_mesh(mesh) -> None:
    """Raise ``NotImplementedError`` for what the data-parallel runtime
    does not run: a 'model' axis larger than 1 (item 13b)."""
    if model_axis_size(mesh) != 1:
        raise NotImplementedError(
            f"a 'model' mesh axis of size {model_axis_size(mesh)} "
            "(tensor parallelism inside a client, models/sharding.py) is "
            f"not ported; the mesh runtime takes 'model' = 1 ({_13B})")


class _Axes:
    """The process groups and this rank's place on the mesh."""

    def __init__(self, mesh):
        axes = client_axes(mesh)
        self.n = n_clients_of(mesh)
        self.n_data = data_axis_size(mesh)
        self.me = client_index(mesh)
        self.pod = self.me // self.n_data
        self.data = self.me % self.n_data
        self.data_group = mesh.get_group(axes[-1])
        self.pod_group = mesh.get_group(axes[0]) if len(axes) > 1 else None
        # with a 'model' axis of 1 the clients are the ranks of the
        # default group (group=None below), rank i being client i
        if dist.get_world_size() != self.n:
            raise ValueError(
                f"the mesh has {self.n} clients but the process group "
                f"{dist.get_world_size()} ranks: build it over the whole "
                "group")


# fp8 containers travel as their bytes (not every backend gathers fp8)
_WIRE = {torch.float8_e4m3fn: torch.uint8}


def _all_gather_rows(row: torch.Tensor, group, size: int) -> torch.Tensor:
    """(1, P) -> (size, P), rows in group-rank order, bit for bit."""
    wire = _WIRE.get(row.dtype)
    send = (row if wire is None else row.view(wire)).contiguous()
    out = torch.empty((size,) + tuple(send.shape[1:]), dtype=send.dtype,
                      device=send.device)
    dist.all_gather_into_tensor(out, send, group=group)
    return out if wire is None else out.view(row.dtype)


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


def _mix_and_aggregate(ax: _Axes, mixing: str, delta: PyTree,
                       A: torch.Tensor, tau: torch.Tensor, m: torch.Tensor,
                       global_params: PyTree,
                       active: Optional[torch.Tensor] = None,
                       quant=None, qstate=None):
    """new_global = global + (1/m) sum_i tau_i (A @ deltas)_i, from this
    rank's ``delta`` (no client axis) and the collectives of ``mixing``.
    With ``quant`` returns ``(new_global, new_qstate)``."""
    i = ax.me
    if mixing == "einsum":
        spec, bufs = _own_rows(delta)
        X = packing.unpack(tuple(_all_gather_rows(b, None, ax.n)
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
            stored = tuple(_all_gather_rows(s, None, ax.n)
                           for s in stored)
            scales = tuple(_all_gather_rows(s, None, ax.n)
                           for s in scales)
            rows = aggregate_grouped_q(A, tau, m, stored, scales,
                                       quant=quant, active=active)
            return (packing.apply_aggregate_row(global_params, rows, spec),
                    new_qstate)
        spec, bufs = _own_rows(delta)
        X = tuple(_all_gather_rows(b, None, ax.n) for b in bufs)
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
    rows = []
    for x in mixed:
        contrib = tau[i].to(x.dtype) * x
        dist.all_reduce(contrib)
        rows.append(contrib.float() / m)
    return packing.apply_aggregate_row(global_params, rows, spec)


def make_train_step(cfg: ModelConfig, mesh, mixing: str = "ring",
                    zero: bool = False, client_impl: str = "vmap",
                    quant=None):
    """Build ``train_step(global_params, tokens, A, tau, m, eta[, prefix]
    [, active][, qstate])`` on this rank.

    tokens: (n_clients, T, B_local, S+1) int -- every client's per-step
    minibatches, inputs and targets adjacent slices; the rank reads its
    own client's row.  prefix (audio/vlm): (n_clients, T, B_local, P,
    fdim).  active: optional (n,) 0/1 straggler mask.  Every tensor on
    ``mesh_device(mesh)``; the global params are replicated on every
    rank, and the new global params come back equal on every rank.

    ``quant`` (a ``packing.QuantSpec``; 'fused' / 'fused_rs' only): the
    step takes this rank's ``qstate`` (``init_rank_quant_state``) and
    returns ``(new_global, new_qstate)``.

    ``client_impl`` is accepted for the reference's API only: at one
    client a rank both values run the same computation, until ROADMAP
    item 13b gives 'shardmap' (SP-MLP, expert-parallel MoE) its own."""
    if mixing not in MIXINGS:
        raise ValueError(f"mixing must be one of {MIXINGS}")
    if client_impl not in ("vmap", "shardmap"):
        raise ValueError("client_impl must be 'vmap' or 'shardmap'")
    if quant is not None and mixing not in ("fused", "fused_rs"):
        raise ValueError(
            "quantized payloads on the mesh runtime require the one-pass "
            f"'fused' or 'fused_rs' schedules, got {mixing!r}")
    if zero:
        raise NotImplementedError(
            "zero=True (ZeRO sharding of the global params) is not "
            f"ported ({_13B})")
    check_mesh(mesh)
    ax = _Axes(mesh)
    model = Model(cfg, device=mesh_device(mesh))

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
        final = local_sgd(model.loss, global_params, batches, eta)
        delta = tree_map(lambda f, g: f - g, final, global_params)
        del final
        return _mix_and_aggregate(ax, mixing, delta, A, tau, m,
                                  global_params, active=active,
                                  quant=quant, qstate=qstate)

    return train_step


def make_scanned_train_steps(cfg: ModelConfig, mesh, K: int,
                             mixing: str = "ring", zero: bool = False,
                             client_impl: str = "vmap", quant=None):
    """K mesh train steps over stacked inputs, as
    ``core.rounds.make_scanned_rounds`` runs K single-host rounds:

    ``scanned(global_params, tokens_seq, A_seq, tau_seq, m_seq, eta_seq[,
    prefix_seq][, active_seq][, qstate]) -> (final_params, params_seq[,
    final_qstate])``, params_seq leaves (K, ...).  The loop body is
    ``make_train_step``'s step on row t of each input, so the trajectory
    is bitwise K sequential steps."""
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
    """This rank's round-0 quantizer state: zero residuals for its own
    client's packed rows, ``(1, P_pad_g)`` (``pack_spec(shards=n_data)``
    on 'fused_rs'), and the key, counter 0."""
    shards = data_axis_size(mesh) if mixing == "fused_rs" else 1
    spec = packing.pack_spec(
        tree_map(lambda p: torch.empty((1,) + tuple(p.shape),
                                       dtype=p.dtype, device="meta"),
                 params), shards=shards, quant=quant)
    return packing.init_quant_state(spec, 1, mesh_device(mesh))


def make_prefill_step(*args, **kwargs):
    """The reference's sharded prefill step (ROADMAP item 12(f))."""
    raise NotImplementedError(
        "the mesh prefill step (item 12(f)) is not ported; serve on one "
        f"device with Model.prefill ({_13B})")


def make_decode_step(*args, **kwargs):
    """The reference's sharded decode step (ROADMAP item 12(f))."""
    raise NotImplementedError(
        "the mesh decode step (item 12(f)) is not ported; serve on one "
        f"device with Model.decode ({_13B})")


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
