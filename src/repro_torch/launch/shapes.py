"""Assigned input shapes and abstract inputs for the dry-run (port of
``repro.launch.shapes``).

Four shapes (assignment):
    train_4k     seq=4096    global_batch=256   -> train_step
    prefill_32k  seq=32768   global_batch=32    -> prefill_step
    decode_32k   seq=32768   global_batch=128   -> decode_step (KV cache)
    long_500k    seq=524288  global_batch=1     -> decode_step, sub-quadratic

``long_500k`` policy, the reference's: SSM/hybrid decode from O(1)/windowed
state natively; every attention arch runs an explicit sliding-window (8192)
ring-buffer cache -- a sub-quadratic O(window) decode path -- so no arch
skips the shape.

The reference builds ``ShapeDtypeStruct``s with shardings
(``jax.eval_shape``).  The port's builders return stand-ins with shapes,
dtypes and a device but no storage -- ``meta`` tensors (the default), or
``FakeTensorMode`` tensors on a real device type (the step then takes
that device's branches) -- holding what one rank of the mesh passes to
its step (``fl/distributed.py``): its shards of the params
(``param_layout``: ``sharding.placement_specs``, with ``zero_specs``
under ``zero``), the step's inputs at the reference's global shapes (the
port's steps take every client's tokens and every row of a batch and
read their own), and its rows and heads of the decode cache.  Beside
them: ``_global``, ``meta`` tensors of every input's whole shape; the
spec trees where the reference returns shardings (``_param_shardings``,
``_cache_shardings``, ``_batch_axes``, ``_client_spec``); and ``_mode``,
the context the step must run under (the ``FakeTensorMode``, or none).
Nothing is ever allocated for the full configs.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.models import sharding as shard_rules
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model
from .mesh import client_axes, data_axis_size, model_axis_size, n_clients_of

PyTree = Any

__all__ = ["InputShape", "SHAPES", "shape_names", "production_config",
           "train_inputs", "prefill_inputs", "decode_inputs", "input_specs",
           "param_structs", "cache_len_for", "LONG_CONTEXT_WINDOW",
           "DEFAULT_T"]

LONG_CONTEXT_WINDOW = 8192          # dense-arch long_500k sliding window
DEFAULT_T = 5                       # paper's local SGD iterations


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str                       # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int
    long_context: bool = False


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1,
                            long_context=True),
}


def shape_names():
    return list(SHAPES)


def production_config(cfg: ModelConfig, shape: InputShape) -> ModelConfig:
    """Adapt an arch config to a production shape: chunked attention for
    long sequences, sliding-window cache for long-context decode on
    attention archs."""
    changes: Dict[str, Any] = {}
    if cfg.uses_attention:
        changes["attn_impl"] = "chunked"
        if shape.long_context and cfg.sliding_window is None:
            changes["sliding_window"] = LONG_CONTEXT_WINDOW
    return dataclasses.replace(cfg, **changes) if changes else cfg


def cache_len_for(cfg: ModelConfig, shape: InputShape) -> int:
    """Ring-buffer depth.  Prefill caches must cover the modality prefix
    too (frontend positions are real attention targets); decode shapes
    specify the KV depth directly."""
    extra = cfg.frontend_len if (cfg.frontend and shape.kind == "prefill") \
        else 0
    if cfg.sliding_window is not None:
        return min(shape.seq_len + extra, cfg.sliding_window)
    return shape.seq_len + extra


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _size(mesh, axis: str) -> int:
    return int(mesh.shape[mesh.mesh_dim_names.index(axis)])


def _batch_axes(batch: int, mesh) -> Optional[Tuple[str, ...]]:
    """Largest prefix of the client axes that divides ``batch``."""
    axes = client_axes(mesh)
    total = 1
    for a in axes:
        total *= _size(mesh, a)
    if batch % total == 0:
        return axes
    # try the trailing ('data',) axis alone
    if batch % _size(mesh, axes[-1]) == 0:
        return (axes[-1],)
    return None


def _mode(device):
    """The context the stand-ins are made and the step runs under: none
    for ``meta`` tensors, else the active ``FakeTensorMode`` or a new
    one."""
    if str(device) == "meta":
        return contextlib.nullcontext()
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    return detect_fake_mode() or FakeTensorMode()


def _meta(tree: PyTree) -> PyTree:
    return tree_map(lambda x: torch.empty(tuple(x.shape), dtype=x.dtype,
                                          device="meta"), tree)


def _local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """A leaf's shape on one rank: each dim over the product of the mesh
    axes its spec entry names."""
    out = []
    for d, entry in zip(shape, tuple(spec) + (None,) * len(shape)):
        axes = () if entry is None else \
            (entry,) if isinstance(entry, str) else tuple(entry)
        div = 1
        for a in axes:
            div *= _size(mesh, a)
        if d % div:
            raise ValueError(f"dim {d} does not split over {axes} ({div})")
        out.append(d // div)
    return tuple(out)


def _local(whole: PyTree, specs: PyTree, mesh, device) -> PyTree:
    leaves, treedef = tree_flatten(whole)
    return tree_unflatten(treedef, [
        torch.empty(_local_shape(x.shape, s, mesh), dtype=x.dtype,
                    device=device)
        for x, s in zip(leaves, shard_rules.spec_leaves(specs))])


def _model_group(mesh):
    return mesh.get_group("model") if model_axis_size(mesh) > 1 else None


def param_structs(model: Model, mesh, zero: bool = False
                  ) -> Tuple[PyTree, PyTree]:
    """(whole shapes: a ``meta`` tensor tree, spec tree): the placement
    the port's steps take (``sharding.placement_specs``; with ``zero``,
    'data' on the split dim of the global copy, ``zero_specs``)."""
    from repro_torch.fl.distributed import zero_specs
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        whole = Model(model.cfg, device="meta").init(torch.Generator())
    whole = _meta(whole)
    specs = shard_rules.placement_specs(whole, model.cfg,
                                        model_axis_size(mesh))
    if zero:
        specs = zero_specs(specs, whole, data_axis_size(mesh))
    return whole, specs


def _stand_in(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# per-kind input builders (fake stand-ins, never allocated)
# ---------------------------------------------------------------------------

def train_inputs(cfg: ModelConfig, shape: InputShape, mesh,
                 T: int = DEFAULT_T, zero: bool = False,
                 device="meta") -> Dict[str, Any]:
    """Inputs for the semi-decentralized ``train_step``
    (``fl.distributed.make_train_step``).

    tokens: (n_clients, T, B_local, S+1) -- per-client, per-local-step
    minibatches (inputs/targets sliced inside the step).  A/tau/m/eta are
    the paper's runtime topology/sampling inputs."""
    assert shape.kind == "train"
    n = n_clients_of(mesh)
    caxes = client_axes(mesh)
    if shape.global_batch % n:
        raise ValueError(f"global_batch {shape.global_batch} not divisible "
                         f"by n_clients {n}")
    b_local = shape.global_batch // n
    whole, specs = param_structs(Model(cfg, device="meta"), mesh, zero=zero)
    glob = {
        "global_params": whole,
        "tokens": ((n, T, b_local, shape.seq_len + 1), torch.int32),
        "A": ((n, n), torch.float32),
        "tau": ((n,), torch.float32),
        "m": ((), torch.float32),
        "eta": ((), torch.float32),
    }
    if cfg.frontend:
        glob["prefix"] = ((n, T, b_local, cfg.frontend_len,
                           cfg.frontend_dim), torch.float32)
    mode = _mode(device)
    out: Dict[str, Any] = {}
    with mode:
        out["global_params"] = _local(whole, specs, mesh, device)
        for k, v in glob.items():
            if k != "global_params":
                out[k] = _stand_in(*v, device)
    out["_global"] = {k: (v if k == "global_params"
                          else torch.empty(v[0], dtype=v[1], device="meta"))
                      for k, v in glob.items()}
    out["_param_shardings"] = specs
    out["_client_spec"] = (caxes,)
    out["_mode"] = mode
    return out


def prefill_inputs(cfg: ModelConfig, shape: InputShape, mesh,
                   device="meta") -> Dict[str, Any]:
    assert shape.kind == "prefill"
    whole, specs = param_structs(Model(cfg, device="meta"), mesh)
    baxes = _batch_axes(shape.global_batch, mesh)
    glob = {"tokens": ((shape.global_batch, shape.seq_len), torch.int32)}
    if cfg.frontend:
        glob["prefix"] = ((shape.global_batch, cfg.frontend_len,
                           cfg.frontend_dim), torch.float32)
    mode = _mode(device)
    out: Dict[str, Any] = {}
    with mode:
        out["params"] = _local(whole, specs, mesh, device)
        for k, v in glob.items():
            out[k] = _stand_in(*v, device)
    out["_global"] = {"params": whole, **{
        k: torch.empty(v[0], dtype=v[1], device="meta")
        for k, v in glob.items()}}
    out["_param_shardings"] = specs
    out["_batch_axes"] = baxes
    out["_mode"] = mode
    return out


def decode_inputs(cfg: ModelConfig, shape: InputShape, mesh,
                  device="meta") -> Dict[str, Any]:
    """One-token ``decode_step`` with a ``seq_len``-deep cache.

    For SSM the cache is the O(1) recurrent state; for attention archs it
    is the (ring-buffered) KV/latent cache sized ``min(seq, window)``.
    The rank's cache holds its rows of the batch (``batch_rows``) and what
    its layers read (its kv heads, the whole MLA latent ring, its SSD
    heads); ``_global`` holds the whole cache and ``_cache_shardings`` the
    reference's specs of it (``sharding.cache_specs``).  ``pos`` is a
    Python int, as ``attention_decode`` reads it on the host."""
    from repro_torch.fl.distributed import batch_rows
    from torch._subclasses.fake_tensor import FakeTensorMode

    assert shape.kind == "decode"
    whole, specs = param_structs(Model(cfg, device="meta"), mesh)
    baxes = _batch_axes(shape.global_batch, mesh)
    W = cache_len_for(cfg, shape)
    with FakeTensorMode():
        cache_whole = _meta(Model(cfg, device="meta").init_cache(
            shape.global_batch, W))
    cache_specs = shard_rules.cache_specs(cache_whole, baxes,
                                          model_axis_size(mesh))
    rows = batch_rows(mesh, baxes, shape.global_batch)
    mode = _mode(device)
    out: Dict[str, Any] = {}
    with mode, shard_rules.model_parallel(_model_group(mesh)):
        out["params"] = _local(whole, specs, mesh, device)
        out["cache"] = Model(cfg, device=device).init_cache(
            rows.stop - rows.start, W)
        out["token"] = _stand_in((shape.global_batch,), torch.int32, device)
    out["pos"] = W - 1
    out["_global"] = {"params": whole, "cache": cache_whole,
                      "token": torch.empty((shape.global_batch,),
                                           dtype=torch.int32,
                                           device="meta")}
    out["_param_shardings"] = specs
    out["_cache_shardings"] = cache_specs
    out["_batch_axes"] = baxes
    out["_mode"] = mode
    return out


def input_specs(arch: str, shape_name: str, mesh, *, T: int = DEFAULT_T,
                zero: bool = False, device="meta") -> Dict[str, Any]:
    """Assignment entry point: fake stand-ins (no allocation) for every
    input of the step function selected by ``shape_name`` for
    architecture ``arch``, as one rank of ``mesh`` on ``device`` passes
    them (module docstring)."""
    from repro_torch.configs import get_config

    shape = SHAPES[shape_name]
    cfg = production_config(get_config(arch), shape)
    if shape.kind == "train":
        return train_inputs(cfg, shape, mesh, T=T, zero=zero, device=device)
    if shape.kind == "prefill":
        return prefill_inputs(cfg, shape, mesh, device=device)
    return decode_inputs(cfg, shape, mesh, device=device)
