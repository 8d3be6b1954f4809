"""Mesh construction over ``torch.distributed`` (port of
``repro.launch.mesh``).

Semi-decentralized-FL mapping, as in the reference: a *client* is one
(pod, data) index of the mesh -- client ``i = pod * n_data + data``,
pod-major -- a *D2D cluster* is one pod, the 'pod' axis carries only the
cross-pod D2S collectives, and the 'model' axis carries tensor
parallelism inside every client (``repro_torch.models.sharding``).  Rank
r sits at ``unravel(r, shape)``: a client's ``model``-axis ranks are
consecutive, and ``make_debug_mesh((2, 2, 2))`` runs four clients of two
ranks each on eight gloo ranks.

There is no ``make_production_mesh``: the reference's is a 512-chip TPU
v5e layout ((2, 16, 16) over pod / data / model), which no machine of
the port has.  ``make_debug_mesh`` builds any mesh the process group
covers: gloo ranks on the CPU (``device='cpu'``) or NCCL ranks, one card
each (the default).  The caller initialises the default process group
first (``torch.distributed.init_process_group`` with its address, world
size and rank): nothing here reads a cluster's environment.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["make_debug_mesh", "client_axes", "n_clients_of",
           "model_axis_size", "data_axis_size", "client_index"]


def make_debug_mesh(shape: Tuple[int, ...],
                    axes: Optional[Tuple[str, ...]] = None,
                    device: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` over the initialised default process
    group (its world size must be ``prod(shape)``); ``axes`` defaults to
    the reference's names, ('pod', 'data', 'model') for three axes and
    ('data', 'model') for two.  Rank r sits at ``unravel(r, shape)``, so
    client i is ranks ``i * m .. i * m + m - 1`` at a 'model' axis of m
    (rank i at m = 1)."""
    from torch.distributed.device_mesh import init_device_mesh

    if axes is None:
        axes = (("pod", "data", "model")[-len(shape):] if len(shape) == 3
                else ("data", "model"))
    return init_device_mesh(device, tuple(shape), mesh_dim_names=tuple(axes))


def _size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def client_axes(mesh) -> Tuple[str, ...]:
    """Mesh axes that enumerate FL clients (everything except 'model')."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def n_clients_of(mesh) -> int:
    n = 1
    for a in client_axes(mesh):
        n *= _size(mesh, a)
    return n


def model_axis_size(mesh) -> int:
    return _size(mesh, "model")


def data_axis_size(mesh) -> int:
    """Size of the innermost client axis ('data') -- the reduce-scatter
    width of the worker-sharded fused mixing path, and the shard count the
    packed-delta buffer must split evenly across
    (``repro_torch.fl.packing.pack_spec(..., shards=...)``)."""
    return _size(mesh, client_axes(mesh)[-1])


def client_index(mesh) -> int:
    """This rank's client: ``pod * n_data + data`` (pod-major)."""
    axes = client_axes(mesh)
    i = 0
    for a in axes:
        i = i * _size(mesh, a) + int(mesh.get_local_rank(a))
    return i
