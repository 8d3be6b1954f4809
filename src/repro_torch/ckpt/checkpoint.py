"""Checkpointing: pytree save/restore with structure-checked restore
(port of ``repro.ckpt.checkpoint``).

Format, the reference's: one ``.npz`` holding the flattened leaves keyed
by their tree path (``core.pytree.tree_flatten_with_paths``: the
reference's keys), plus a ``.json`` sidecar ``{"step", "meta", "keys"}``.
Atomic via tmp-file + rename, so a crash mid-save never corrupts the
latest checkpoint.  Round-resumable: server state (m_next, rng state) can
be carried in ``meta``.  A file either package writes, the other reads.

bf16 leaves have no numpy dtype.  The reference's ``np.savez`` stores a
bf16 leaf as its raw bytes under the descr ``'<V2'`` (the ``ml_dtypes``
array's), and its ``load_checkpoint`` cannot cast that back
(``ValueError``).  The port writes the same member bytes and restores
such an array into a bf16 leaf by viewing its bytes, so bf16 trees
round-trip here: a deliberate difference from the reference.
"""

from __future__ import annotations

import json
import os
import tempfile
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pytree import tree_flatten_with_paths, tree_unflatten

PyTree = Any

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint"]

# a dtype numpy lacks: stored as raw bytes (a same-width integer view),
# under the descr ml_dtypes gives it in the reference's files
_RAW = {torch.bfloat16: torch.int16}


def _host(leaf) -> np.ndarray:
    """A leaf as the numpy array the file holds (a raw-bytes dtype as
    ``V<itemsize>``), sharing a CPU tensor's memory."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype in _RAW:
        return t.contiguous().view(_RAW[t.dtype]).numpy().view(
            f"V{t.element_size()}")
    return t.numpy()


def _write_npy(fid, arr: np.ndarray) -> None:
    """``np.lib.format.write_array``, with a raw-bytes leaf's header descr
    little-endian as the reference's ml_dtypes arrays write it."""
    fmt = np.lib.format
    if arr.dtype.kind != "V":
        fmt.write_array(fid, arr, allow_pickle=False)
        return
    header = fmt.header_data_from_array_1_0(arr)
    header["descr"] = "<" + arr.dtype.str[1:]
    fmt.write_array_header_1_0(fid, header)
    fid.write(np.ascontiguousarray(arr).data)


def _savez(f, flat: Dict[str, np.ndarray]) -> None:
    # np.savez's container: a stored (uncompressed) zip, one .npy a key
    with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, arr in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                _write_npy(fid, arr)


def save_checkpoint(directory: str, step: int, params: PyTree,
                    meta: Optional[Dict[str, Any]] = None,
                    keep: int = 3) -> str:
    """Write ``params`` (tensors on any device) as ``ckpt_<step>.npz`` +
    ``.json`` in ``directory``, keeping the newest ``keep`` checkpoints
    (``keep=0`` keeps all); returns the ``.npz`` path."""
    os.makedirs(directory, exist_ok=True)
    name = f"ckpt_{step:08d}"
    flat = {k: _host(leaf) for k, leaf in tree_flatten_with_paths(params)[0]}

    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".npz.tmp")
    os.close(fd)
    try:
        with open(tmp, "wb") as f:
            _savez(f, flat)
        os.replace(tmp, os.path.join(directory, name + ".npz"))
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)

    sidecar = {"step": step, "meta": meta or {},
               "keys": sorted(flat.keys())}
    tmp_json = os.path.join(directory, name + ".json.tmp")
    with open(tmp_json, "w") as f:
        json.dump(sidecar, f, indent=1)
    os.replace(tmp_json, os.path.join(directory, name + ".json"))

    _gc(directory, keep)
    return os.path.join(directory, name + ".npz")


def _gc(directory: str, keep: int) -> None:
    ckpts = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    for stale in ckpts[:-keep] if keep else []:
        base = stale[:-len(".npz")]
        for ext in (".npz", ".json"):
            p = os.path.join(directory, base + ext)
            if os.path.exists(p):
                os.unlink(p)


def latest_checkpoint(directory: str) -> Optional[str]:
    if not os.path.isdir(directory):
        return None
    ckpts = sorted(f for f in os.listdir(directory)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    return os.path.join(directory, ckpts[-1]) if ckpts else None


def _restore(arr: np.ndarray, leaf: torch.Tensor) -> torch.Tensor:
    """``arr`` as a tensor of ``leaf``'s dtype on its device: a raw-bytes
    array into a bf16 leaf by a view of its bytes, anything else
    cast by numpy as the reference casts (a raw array into another dtype
    raises its ``ValueError``).  One host-to-device copy."""
    if arr.dtype.kind == "V" and leaf.dtype in _RAW \
            and arr.dtype.itemsize == leaf.element_size():
        raw = _RAW[leaf.dtype]
        host = torch.from_numpy(arr.view(
            torch.empty((), dtype=raw).numpy().dtype)).view(leaf.dtype)
    else:
        np_dtype = torch.empty((), dtype=leaf.dtype).numpy().dtype
        host = torch.from_numpy(np.ascontiguousarray(
            arr.astype(np_dtype, copy=False)))
    return host.to(leaf.device)


def load_checkpoint(path: str, like: PyTree
                    ) -> Tuple[PyTree, Dict[str, Any]]:
    """Restore into the structure of ``like`` (keys and shapes checked):
    ``(params, sidecar)``.  Each leaf comes back as a tensor with the
    ``like`` leaf's dtype on its device (the reference returns numpy
    arrays)."""
    with np.load(path) as npz:
        flat = {k: npz[k] for k in npz.files}
    leaves_paths, treedef = tree_flatten_with_paths(like)
    ref = {k for k, _ in leaves_paths}
    if ref != set(flat):
        missing = ref - set(flat)
        extra = set(flat) - ref
        raise ValueError(f"checkpoint structure mismatch: "
                         f"missing={sorted(missing)[:5]} extra={sorted(extra)[:5]}")
    new_leaves = []
    for key, leaf in leaves_paths:
        arr = flat.pop(key)
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch at {key}: "
                             f"{arr.shape} vs {tuple(leaf.shape)}")
        new_leaves.append(_restore(arr, leaf))
    params = tree_unflatten(treedef, new_leaves)

    meta_path = path[:-len(".npz")] + ".json"
    meta: Dict[str, Any] = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return params, meta
