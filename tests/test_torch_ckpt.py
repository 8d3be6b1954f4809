"""The port's checkpoints (``repro_torch.ckpt``) against the reference's
(``repro.ckpt``): the same path keys, the same files read either way,
and resuming a plan from a checkpoint equal to the uninterrupted run.

Tolerances: none -- every comparison here is bitwise (``np.array_equal``
/ ``torch.equal`` on the restored leaves, equal History rows, equal
file members).  The one deliberate difference: a bf16 leaf round-trips
in the port, where the reference's ``load_checkpoint`` raises.
"""

import json
import os
import zipfile
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import checkpoint as jckpt
from repro_torch import topology
from repro_torch.ckpt import (latest_checkpoint, load_checkpoint,
                              save_checkpoint)
from repro_torch.core.pytree import tree_flatten, tree_flatten_with_paths
from repro_torch.core.server import ServerConfig
from repro_torch.fl.engine import ExecutionConfig, make_engine
from repro_torch.fl.plan import RoundPlan

FIXTURE = Path(__file__).resolve().parent / "data" / "ckpt_ref"


class State(NamedTuple):
    mu: dict
    nu: list


def _leaves(tree):
    return [np.asarray(x) if not isinstance(x, torch.Tensor)
            else x.numpy() for x in tree_flatten(tree)[0]]


# ---------------------------------------------------------------------------
# twins of tests/test_substrates.py
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip(tmp_path):
    params = {"layer": {"w": torch.arange(6.0).reshape(2, 3),
                        "b": torch.zeros(3)},
              "head": torch.ones((4,), dtype=torch.float32)}
    p = save_checkpoint(str(tmp_path), 7, params, meta={"m_next": 12})
    assert latest_checkpoint(str(tmp_path)) == p
    restored, meta = load_checkpoint(
        p, {"layer": {"w": torch.zeros(2, 3), "b": torch.zeros(3)},
            "head": torch.zeros(4)})
    assert meta["step"] == 7 and meta["meta"]["m_next"] == 12
    for a, b in zip(tree_flatten(restored)[0], tree_flatten(params)[0]):
        assert isinstance(a, torch.Tensor) and torch.equal(a, b)


def test_checkpoint_gc_and_mismatch(tmp_path):
    params = {"w": torch.ones(3)}
    for s in range(5):
        save_checkpoint(str(tmp_path), s, params, keep=2)
    ckpts = [f for f in os.listdir(tmp_path) if f.endswith(".npz")]
    assert len(ckpts) == 2
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(latest_checkpoint(str(tmp_path)),
                        {"w": torch.ones(3), "extra": torch.ones(1)})
    with pytest.raises(ValueError, match="shape mismatch"):
        load_checkpoint(latest_checkpoint(str(tmp_path)),
                        {"w": torch.ones((4,))})


def test_keep_zero_keeps_every_checkpoint(tmp_path):
    for s in range(4):
        save_checkpoint(str(tmp_path), s, {"w": torch.ones(2)}, keep=0)
    assert sorted(os.listdir(tmp_path)) == sorted(
        f"ckpt_{s:08d}{ext}" for s in range(4) for ext in (".npz", ".json"))
    assert latest_checkpoint(str(tmp_path / "absent")) is None


# ---------------------------------------------------------------------------
# twin of tests/test_plan_resume.py: crash / resume == uninterrupted
# ---------------------------------------------------------------------------

def _quad_loss(params, batch):
    x = params["x"]
    b, = batch
    return 0.5 * torch.sum((x - b.mean(dim=0)) ** 2)


def _plan(t_max=6, seed=3, n=12, c=2):
    net = topology.make_spec("k_regular", n=n, c=c, k_range=(4, 6),
                             p_fail=0.1).build()
    cfg = ServerConfig(T=2, t_max=t_max, phi_max=0.3, seed=seed,
                       eta=lambda t: 0.2 / (1 + 0.3 * t))
    return RoundPlan.connectivity_aware(net, cfg)


def _batches(n, rounds, p=4, T=2, B=2, seed=1):
    rng = np.random.default_rng(seed)
    targets = rng.standard_normal((n, p)).astype(np.float32)
    out = []
    for _ in range(rounds):
        samp = targets[:, None, None, :] \
            + 0.05 * rng.standard_normal((n, T, B, p))
        out.append((torch.from_numpy(samp.astype(np.float32)),))
    return out


@pytest.mark.parametrize("backend", ["einsum", "fused"])
@pytest.mark.parametrize("scan", [False, True])
def test_resume_from_checkpoint_matches_uninterrupted_bitwise(tmp_path,
                                                              scan, backend):
    K, t0, n = 6, 3, 12
    plan = _plan(t_max=K).with_dropout(0.2, np.random.default_rng(7))
    batches = _batches(n, K)
    params0 = {"x": torch.zeros(4)}

    def eval_fn(p):
        return {"l2": float(torch.sum(p["x"] ** 2))}

    def engine():
        return make_engine(ExecutionConfig(backend=backend, scan=scan),
                           _quad_loss, device="cpu")

    params_full, hist_full = engine().execute(plan, params0, batches,
                                              eval_fn=eval_fn)
    params_head, hist_head = engine().execute(plan[:t0], params0,
                                              batches[:t0],
                                              eval_fn=eval_fn)
    path = save_checkpoint(str(tmp_path), t0, params_head,
                           meta={"t0": t0})
    restored, meta = load_checkpoint(path, like=params0)
    assert meta["meta"]["t0"] == t0
    params_res, hist_res = engine().execute(plan[t0:], restored,
                                            batches[t0:], eval_fn=eval_fn)

    assert torch.equal(params_full["x"], params_res["x"])
    stitched = hist_head.records + hist_res.records
    assert [r.t for r in stitched] == [r.t for r in hist_full.records]
    for a, b in zip(stitched, hist_full.records):
        assert (a.m, a.m_actual, a.d2s, a.d2d, a.eta, a.psi_bound) == \
            (b.m, b.m_actual, b.d2s, b.d2d, b.eta, b.psi_bound)
        assert a.metrics == b.metrics
    np.testing.assert_array_equal(
        np.concatenate([hist_head.ledger.cumulative_cost(),
                        hist_head.ledger.cumulative_cost()[-1]
                        + hist_res.ledger.cumulative_cost()]),
        hist_full.ledger.cumulative_cost())


# ---------------------------------------------------------------------------
# across the two packages
# ---------------------------------------------------------------------------

def _trees():
    z = np.zeros
    return {
        "nested": {"opt": State(mu={"w": z(2, np.float32)},
                                nu=[z(1, np.float32), None]),
                   "x": (z(3, np.float32),), "e": None,
                   "sc": np.float32(1)},
        "lists": [{"b": z(1), "a": [z(2), (z(3), None)]}, z(4)],
        "named_root": State(mu={"k": z(1), "j": {"i": z(2)}}, nu=[]),
        "leaf": z(5, np.int32),
        "int_keys": {3: z(1), 10: z(2), 2: {0: z(1)}},
    }


@pytest.mark.parametrize("name", sorted(_trees()))
def test_path_keys_equal_the_references(name):
    tree = _trees()[name]
    jax_keys = list(jckpt._flatten_with_paths(tree))
    keys = [k for k, _ in tree_flatten_with_paths(tree)[0]]
    assert keys == jax_keys
    assert len(keys) == len(tree_flatten(tree)[0])


def _mixed_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"layer": {"w": rng.standard_normal((4, 8)).astype(np.float32),
                      "b": rng.standard_normal(8).astype(np.float32)},
            "step_count": rng.integers(-2**31, 2**31 - 1, 3,
                                       dtype=np.int64).astype(np.int32),
            "head": [rng.standard_normal(5).astype(np.float32),
                     rng.integers(0, 100, (2, 2)).astype(np.int32)]}


def _as_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _sidecar(path):
    with open(path[:-len(".npz")] + ".json") as f:
        return json.load(f)


def test_reference_file_loads_in_the_port_bitwise(tmp_path):
    tree = _mixed_tree()
    path = jckpt.save_checkpoint(str(tmp_path), 4,
                                 jax.tree.map(jnp.asarray, tree),
                                 meta={"m_next": 9})
    like = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(
        a).dtype), tree)
    restored, meta = load_checkpoint(path, like)
    assert meta == {"step": 4, "meta": {"m_next": 9},
                    "keys": sorted(jckpt._flatten_with_paths(tree))}
    for a, b in zip(_leaves(restored), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_port_file_loads_in_the_reference_bitwise(tmp_path):
    tree = _mixed_tree(1)
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 4,
                                  jax.tree.map(jnp.asarray, tree),
                                  meta={"m_next": 9})
    path = save_checkpoint(str(tmp_path / "t"), 4, _as_torch(tree),
                           meta={"m_next": 9})
    restored, meta = jckpt.load_checkpoint(path, tree)
    assert meta == _sidecar(jpath)
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the .npy members are the same bytes
    with zipfile.ZipFile(path) as zt, zipfile.ZipFile(jpath) as zj:
        assert sorted(zt.namelist()) == sorted(zj.namelist())
        for name in zj.namelist():
            assert zt.read(name) == zj.read(name), name


def test_bf16_same_bytes_port_restores_reference_raises(tmp_path):
    rng = np.random.default_rng(2)
    vals = rng.standard_normal((3, 5)).astype(np.float32)
    jtree = {"w": jnp.asarray(vals, jnp.bfloat16),
             "f": jnp.asarray(vals[0])}
    ttree = {"w": torch.from_numpy(vals).to(torch.bfloat16),
             "f": torch.from_numpy(vals[0])}
    jpath = jckpt.save_checkpoint(str(tmp_path / "j"), 0, jtree)
    path = save_checkpoint(str(tmp_path / "t"), 0, ttree)
    with zipfile.ZipFile(path) as zt, zipfile.ZipFile(jpath) as zj:
        assert zt.read("w.npy") == zj.read("w.npy")
        assert zt.read("f.npy") == zj.read("f.npy")
    with np.load(path) as npz:
        assert npz["w"].dtype.kind == "V" and npz["w"].dtype.itemsize == 2
    like = {"w": torch.zeros((3, 5), dtype=torch.bfloat16),
            "f": torch.zeros(5)}
    for p in (path, jpath):
        restored, _ = load_checkpoint(p, like)
        assert restored["w"].dtype == torch.bfloat16
        assert torch.equal(restored["w"].view(torch.int16),
                           ttree["w"].view(torch.int16))
        assert torch.equal(restored["f"], ttree["f"])
    # the deliberate difference: the reference cannot cast 'V2' back
    for p in (path, jpath):
        with pytest.raises(ValueError):
            jckpt.load_checkpoint(p, jtree)
    # nor can the port restore raw bytes into another dtype
    with pytest.raises(ValueError):
        load_checkpoint(path, {"w": torch.zeros((3, 5)),
                               "f": torch.zeros(5)})


def _fixture_path():
    return str(FIXTURE / "ckpt_00000002.npz")


def test_committed_reference_fixture_loads_bitwise(tmp_path):
    """``tests/data/ckpt_ref`` was written by the reference's
    ``save_checkpoint(dir, 2, _mixed_tree(5), meta={"t0": 2})``: the port
    reads it bitwise, and the reference writes the same members today."""
    tree = _mixed_tree(5)
    like = jax.tree.map(lambda a: torch.zeros(a.shape, dtype=torch.from_numpy(
        a).dtype), tree)
    restored, meta = load_checkpoint(_fixture_path(), like)
    assert meta["step"] == 2 and meta["meta"] == {"t0": 2}
    for a, b in zip(_leaves(restored), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    again = jckpt.save_checkpoint(str(tmp_path), 2,
                                  jax.tree.map(jnp.asarray, tree),
                                  meta={"t0": 2})
    with zipfile.ZipFile(again) as zj, \
            zipfile.ZipFile(_fixture_path()) as zf:
        for name in zj.namelist():
            assert zf.read(name) == zj.read(name), name
    assert _sidecar(again) == _sidecar(_fixture_path())
