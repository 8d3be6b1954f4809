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

``make_debug_mesh`` builds any mesh the process group covers: gloo ranks
on the CPU (``device='cpu'``) or NCCL ranks, one card each (the
default).  ``make_production_mesh`` is a stand-in for the reference's
512-chip TPU v5e layout at the port's scale (``production_shape``).  The
caller initialises the default process group first
(``torch.distributed.init_process_group`` with its address, world size
and rank): nothing here reads a cluster's environment.
"""

from __future__ import annotations

from typing import Optional, Tuple

__all__ = ["make_debug_mesh", "make_production_mesh", "production_shape",
           "client_axes", "n_clients_of", "model_axis_size",
           "data_axis_size", "client_index"]

# the reference's 'model' axis: 16 chips of one ICI domain
PRODUCTION_MODEL = 16


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


def production_shape(world: int, node: int, multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """The production layout over ``world`` ranks, ``node`` of them one
    node's cards (the fast domain): 'model' inside the node, as many of
    its cards as divide it up to the reference's 16; the clients ('data')
    across nodes; 'pod' = 2 in front with ``multi_pod``.  Returns
    (shape, axis names), ('data', 'model') or ('pod', 'data', 'model').
    A world that does not factor so raises ``ValueError`` naming the
    shape it tried."""
    pods = 2 if multi_pod else 1
    model = max(min(node, PRODUCTION_MODEL, world), 1)
    shape = ((pods,) if multi_pod else ()) + (world // (pods * model),
                                              model)
    axes = (("pod",) if multi_pod else ()) + ("data", "model")
    if world <= 0 or node <= 0 or world % (pods * model) or \
            shape[-2] == 0 or node % model:
        raise ValueError(
            f"a world of {world} ranks ({node} a node) does not factor "
            f"into the production layout {dict(zip(axes, shape))}: "
            f"{'pod (2) x ' if multi_pod else ''}data x model with "
            f"'model' ({model}) inside one node")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False, node: int = 0,
                         device: str = "cuda"):
    """The stand-in for the reference's production mesh over the
    initialised world: (data, model) or, ``multi_pod``, (pod, data,
    model), laid out by ``production_shape`` with ``node`` ranks a node
    (default: this machine's card count, or the whole world on the CPU).

    What differs from the reference's 512-chip layout, (16, 16) / (2, 16,
    16) on TPU v5e: the sizes follow the world and the node (a 'model'
    axis of at most 16 cards of one node over NVLink, the clients across
    nodes over the network, and a 'pod' axis of 2 that is not a separate
    interconnect domain unless the world spans two); the axes, their
    order and the mapping of clients, clusters and tensor parallelism
    onto them are the reference's."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size()
    if not node:
        node = torch.cuda.device_count() if device == "cuda" else world
    shape, axes = production_shape(world, node, multi_pod)
    return make_debug_mesh(shape, axes, device=device)


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
