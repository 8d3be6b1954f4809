"""Packed delta layout of the PyTorch port against the JAX reference.

``jax.tree.flatten`` visits dict keys in sorted order; the port's own
flatten (``repro_torch.core.pytree``) must do the same, or the packed
buffers, ``P_pad`` and the byte counts drift from the reference.  The
trees here are built with keys in *unsorted* insertion order and mixed
fp32 / bf16 leaves, and everything is compared element for element
(exact: packing only moves values).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fl import packing as jpacking
from repro_torch.core.pytree import tree_flatten, tree_map, tree_unflatten
from repro_torch.fl import packing

jax.config.update("jax_enable_x64", False)

N = 3


def _trees(seed=0):
    """Equal delta trees for both packages: unsorted keys, nested dicts,
    fp32 and bf16 leaves, sizes that leave ragged padding."""
    rng = np.random.default_rng(seed)
    spec = {"zeta": ((N, 7, 3), "f32"),
            "alpha": {"w": ((N, 5, 11), "bf16"), "b": ((N, 11), "f32")},
            "mid": ((N, 130), "bf16"),
            "beta": {"k": ((N, 2, 2, 3), "f32")}}

    def build(node, framework):
        if isinstance(node, dict):
            return {k: build(v, framework) for k, v in node.items()}
        shape, dt = node
        a = rng.standard_normal(shape).astype(np.float32)
        return a if framework is None else framework(a, dt)

    raw = build(spec, None)
    j = jax.tree.map(lambda a, s: jnp.asarray(a, jnp.bfloat16 if s == "bf16"
                                              else jnp.float32),
                     raw, _dtypes(spec))
    t = tree_map(lambda a, s: torch.from_numpy(a).to(
        torch.bfloat16 if s == "bf16" else torch.float32),
        raw, _dtypes(spec))
    return j, t


def _dtypes(spec):
    if isinstance(spec, dict):
        return {k: _dtypes(v) for k, v in spec.items()}
    return spec[1]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def test_flatten_follows_jax_sorted_key_order():
    jtree, ttree = _trees()
    jl = jax.tree.leaves(jtree)
    tl, treedef = tree_flatten(ttree)
    assert [a.shape for a in jl] == [tuple(t.shape) for t in tl]
    for a, t in zip(jl, tl):
        np.testing.assert_array_equal(_np(t), _np(a))
    back = tree_unflatten(treedef, tl)
    assert list(back) == sorted(ttree)


@pytest.mark.parametrize("shards", [1, 3])
def test_pack_layout_and_bytes_equal_reference(shards):
    jtree, ttree = _trees()
    jspec = jpacking.pack_spec(jtree, shards=shards)
    spec = packing.pack_spec(ttree, shards=shards)
    assert spec.n_groups == jspec.n_groups == 2
    for g, jg in zip(spec.groups, jspec.groups):
        assert str(g.dtype).split(".")[-1] == jnp.dtype(jg.dtype).name
        assert (g.leaf_ids, g.shapes, g.offsets, g.sizes, g.total,
                g.padded) == (jg.leaf_ids, jg.shapes, jg.offsets, jg.sizes,
                              jg.total, jg.padded)
    assert spec.padded == jspec.padded and spec.total == jspec.total
    assert spec.nbytes(N) == jspec.nbytes(N)
    assert packing.promoted_nbytes(spec, N) == \
        jpacking.promoted_nbytes(jspec, N)

    jbufs = jpacking.pack(jtree, jspec)
    bufs = packing.pack(ttree, spec)
    for b, jb in zip(bufs, jbufs):
        assert tuple(b.shape) == jb.shape
        np.testing.assert_array_equal(_np(b), _np(jb))

    back = packing.unpack(bufs, spec)
    jback = jpacking.unpack(jbufs, jspec)
    for t, a in zip(tree_flatten(back)[0], jax.tree.leaves(jback)):
        assert t.dtype in (torch.float32, torch.bfloat16)
        np.testing.assert_array_equal(_np(t), _np(a))


def test_unpack_row_and_apply_aggregate_row_equal_reference():
    jtree, ttree = _trees(seed=1)
    jspec = jpacking.pack_spec(jtree)
    spec = packing.pack_spec(ttree)
    rng = np.random.default_rng(2)
    rows = [rng.standard_normal(g.padded).astype(np.float32)
            for g in spec.groups]
    jglobal = jax.tree.map(lambda x: x[0], jtree)
    tglobal = tree_map(lambda x: x[0].clone(), ttree)
    want = jpacking.apply_aggregate_row(
        jglobal, tuple(jnp.asarray(r) for r in rows), jspec)
    got = packing.apply_aggregate_row(
        tglobal, tuple(torch.from_numpy(r) for r in rows), spec)
    for t, a, g in zip(tree_flatten(got)[0], jax.tree.leaves(want),
                       tree_flatten(tglobal)[0]):
        assert t.dtype == g.dtype
        np.testing.assert_array_equal(_np(t), _np(a))
    got_rows = packing.unpack_row(tuple(torch.from_numpy(r) for r in rows),
                                  spec)
    want_rows = jpacking.unpack_row(tuple(jnp.asarray(r) for r in rows),
                                    jspec)
    for t, a in zip(tree_flatten(got_rows)[0], jax.tree.leaves(want_rows)):
        np.testing.assert_array_equal(_np(t), _np(a))


def test_cnn_packs_to_the_reference_width():
    from repro.models import cnn as jcnn
    from repro_torch.models import cnn

    jp = jax.tree.map(lambda x: x[None], jcnn.init_cnn(0))
    tp = tree_map(lambda x: x[None], cnn.init_cnn(0))
    spec, jspec = packing.pack_spec(tp), jpacking.pack_spec(jp)
    assert spec.total == jspec.total == 1_663_370
    assert spec.padded == jspec.padded == 1_663_488
    assert spec.nbytes(70) == jspec.nbytes(70)


def test_pack_rejects_mismatched_trees():
    _, ttree = _trees()
    spec = packing.pack_spec(ttree)
    bad = dict(ttree, zeta=ttree["zeta"].to(torch.bfloat16))
    with pytest.raises(ValueError, match="dtype"):
        packing.pack(bad, spec)
    with pytest.raises(ValueError, match="treedef"):
        packing.pack({"zeta": ttree["zeta"]}, spec)
