"""The port's shape specs, dry-run and roofline (``repro_torch.launch.
shapes``, ``launch.dryrun``, ``roofline``) against the reference's
(``repro.launch.shapes``, ``repro.roofline``), and the fake world's tally
against a real two-rank gloo run's.

Tolerances, stated per check:

* shapes, configs, specs, cache depths, the op_cost twins of the
  reference's ``jaxpr_cost`` tests, and ``roofline_report`` /
  ``model_flops`` given the reference's constants: exact (floats from the
  same arithmetic, compared with ``==``);
* FLOPs of a reduced model's forward and of ``grad(Model.loss)`` against
  the reference's ``cost_of_lowered``: within 2% (the two count the same
  products; what differs is counted below 0.2%: the gradient of the
  embedding gather and of the SSD's scan pieces, which XLA and autograd
  form as products of different shapes);
* the fake world's tally (FLOPs, bytes, collectives by kind, by mesh axis
  and by count) against a real run's at mesh (1, 1, 2): equal.  For the
  MoE arch FLOPs and collectives only: the per-expert loop's bytes follow
  which experts the real routing leaves empty.

The process groups live in subprocesses (this file run as a script:
``python tests/test_torch_dryrun.py worker RANK DIR ARCHS`` for the two
gloo ranks, ``... fake 0 DIR ARCHS`` for the fake world) or in a
module fixture that makes a one-rank fake world and destroys it.
"""

import dataclasses
import json
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve()
SRC = HERE.parents[1] / "src"
TALLY_ARCHS = ("stablelm-1.6b", "phi3.5-moe-42b-a6.6b", "mamba2-1.3b",
               "deepseek-v2-236b")
MOE_ARCHS = ("phi3.5-moe-42b-a6.6b",)
N, T, B, S = 1, 2, 2, 16           # the tally's step: one client, T steps


def _env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")


# ---------------------------------------------------------------------------
# the tally workers (this file run as a script)
# ---------------------------------------------------------------------------

def _tally_worker(mode: str, rank: int, out: Path, archs) -> None:
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.fl import distributed as D
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import sharding
    from repro_torch.models.model import Model
    from repro_torch.roofline import cost_of

    torch.set_num_threads(1)
    real = mode == "worker"
    if real:
        dist.init_process_group("gloo", init_method=f"file://{out}/store",
                                rank=rank, world_size=2,
                                timeout=timedelta(seconds=240))
    else:
        dryrun.fake_world(2)
    mesh = make_debug_mesh((1, 1, 2), device="cpu")
    dev = "cpu" if real else "meta"
    res = {}
    for arch in archs:
        cfg = dataclasses.replace(get_config(arch, reduced=True),
                                  attn_impl="chunked", attn_chunk=8)
        gen = torch.Generator().manual_seed(0)

        def ints(*shape):
            if real:
                return torch.randint(0, cfg.vocab_size, shape, generator=gen,
                                     dtype=torch.int32)
            return torch.empty(shape, dtype=torch.int32, device=dev)

        def vals(*shape):
            if real:
                return torch.rand(shape, generator=gen)
            return torch.empty(shape, device=dev)

        if real:
            params = D.shard_params(Model(cfg, device="cpu").init(gen), cfg,
                                    mesh)
        else:
            whole, specs = shapes.param_structs(Model(cfg, device="cpu"),
                                                mesh)
            params = shapes._local(whole, specs, mesh, dev)
        P = cfg.frontend_len if cfg.frontend else 0
        extra = (vals(N, T, B, P, cfg.frontend_dim),) if cfg.frontend else ()
        step = D.make_train_step(cfg, mesh, mixing="ring")
        res[f"{arch}/train"] = cost_of(
            step, params, ints(N, T, B, S + 1), vals(N, N), vals(N),
            vals(), vals(), *extra, mesh=mesh)
        prompt = ints(2, S)
        pextra = (vals(2, P, cfg.frontend_dim),) if cfg.frontend else ()
        pre = D.make_prefill_step(cfg, mesh, ("data",), cache_len=S + P + 4)
        res[f"{arch}/prefill"] = cost_of(pre, params, prompt, *pextra,
                                         mesh=mesh)
        if real:
            _, cache = pre(params, prompt, *pextra)
        else:
            with sharding.model_parallel(mesh.get_group("model")):
                cache = Model(cfg, device=dev).init_cache(2, S + P + 4)
        dec = D.make_decode_step(cfg, mesh, ("data",))
        res[f"{arch}/decode"] = cost_of(dec, params, cache, ints(2),
                                        S + P, mesh=mesh)
    if rank == 0:
        (out / f"{mode}.json").write_text(json.dumps(res, sort_keys=True))
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def tallies(tmp_path_factory):
    out = tmp_path_factory.mktemp("tally")
    archs = ",".join(TALLY_ARCHS)
    cmds = [[sys.executable, str(HERE), "worker", str(r), str(out), archs]
            for r in range(2)]
    cmds.append([sys.executable, str(HERE), "fake", "0", str(out), archs])
    procs = [subprocess.Popen(c, env=_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    logs = [p.communicate(timeout=400)[0].decode() for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return (json.loads((out / "worker.json").read_text()),
            json.loads((out / "fake.json").read_text()))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", TALLY_ARCHS)
def test_fake_world_tally_equals_a_gloo_run(tallies, arch, kind):
    real, fake = (t[f"{arch}/{kind}"] for t in tallies)
    assert real["flops"] > 0 and real["collective_ops"]
    assert real["collectives_by_axis"].get("model", 0) > 0
    keys = ("flops", "collectives", "collectives_by_axis", "collective_ops",
            "unknown_while")
    if arch not in MOE_ARCHS:
        keys += ("bytes", "bytes_by_class")
    for k in keys:
        assert fake[k] == real[k], k


# ---------------------------------------------------------------------------
# shapes vs the reference
# ---------------------------------------------------------------------------

def _archs():
    from repro_torch.configs import arch_names
    return arch_names()


SHAPE_NAMES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
COMBOS = [(a, s) for a in _archs() for s in SHAPE_NAMES]


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_shapes_configs_and_cache_depths_equal_the_references(arch, shape):
    from repro.configs import get_config as j_get_config
    from repro.launch import shapes as J
    from repro_torch.configs import get_config
    from repro_torch.launch import shapes as S_

    assert S_.shape_names() == J.shape_names()
    assert dataclasses.asdict(S_.SHAPES[shape]) == \
        dataclasses.asdict(J.SHAPES[shape])
    cfg = S_.production_config(get_config(arch), S_.SHAPES[shape])
    jcfg = J.production_config(j_get_config(arch), J.SHAPES[shape])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert S_.cache_len_for(cfg, S_.SHAPES[shape]) == \
        J.cache_len_for(jcfg, J.SHAPES[shape])
    assert (S_.LONG_CONTEXT_WINDOW, S_.DEFAULT_T) == \
        (J.LONG_CONTEXT_WINDOW, J.DEFAULT_T)


def test_cache_len_for_adds_prefix_on_prefill():
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import (SHAPES, cache_len_for,
                                           production_config)
    cfg = production_config(get_config("internvl2-1b"),
                            SHAPES["prefill_32k"])
    assert cache_len_for(cfg, SHAPES["prefill_32k"]) == 32768 + 256
    assert cache_len_for(cfg, SHAPES["decode_32k"]) == 32768
    cfg_l = production_config(get_config("internvl2-1b"),
                              SHAPES["long_500k"])
    assert cache_len_for(cfg_l, SHAPES["long_500k"]) == 8192


@pytest.fixture(scope="module")
def one_rank_mesh():
    import torch.distributed as dist

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import make_debug_mesh

    assert not dist.is_initialized()
    fake_world(1)
    try:
        yield make_debug_mesh((1, 1), device="cpu")
    finally:
        dist.destroy_process_group()


def _abstract(t):
    from torch._subclasses.fake_tensor import is_fake
    return t.is_meta or is_fake(t)


def test_input_specs_are_abstract(one_rank_mesh):
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.launch import shapes as S_

    mesh = one_rank_mesh
    cfg = S_.production_config(get_config("qwen3-32b"),
                               S_.SHAPES["train_4k"])
    for device in ("meta", "cpu"):
        inp = S_.train_inputs(cfg, S_.SHAPES["train_4k"], mesh, T=2,
                              device=device)
        leaves = tree_leaves(inp["global_params"])
        assert leaves and all(_abstract(x) for x in leaves)
        assert tuple(inp["tokens"].shape) == (1, 2, 256, 4097)
    cfg_l = S_.production_config(get_config("qwen3-32b"),
                                 S_.SHAPES["long_500k"])
    assert cfg_l.sliding_window == S_.LONG_CONTEXT_WINDOW
    assert cfg_l.attn_impl == "chunked"
    dec = S_.decode_inputs(cfg_l, S_.SHAPES["long_500k"], mesh)
    assert all(_abstract(x) for x in tree_leaves(dec["cache"]))
    # ring buffer is window-sized, not 500k
    assert dec["cache"]["layers"]["k"].shape[2] == S_.LONG_CONTEXT_WINDOW


def _jax_paths(tree):
    import jax
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _torch_paths(tree):
    from repro_torch.core.pytree import tree_flatten_with_paths
    return dict(tree_flatten_with_paths(tree)[0])


def _same_structs(port, ref, specs=None, ref_specs=None):
    got, want = _torch_paths(port), _jax_paths(ref)
    assert sorted(got) == sorted(want)
    for k, x in got.items():
        assert tuple(x.shape) == tuple(want[k].shape), k
        assert str(x.dtype).split(".")[-1] == str(want[k].dtype), k


@pytest.mark.parametrize("arch,shape", COMBOS)
def test_input_specs_match_the_references(one_rank_mesh, arch, shape):
    """Global shapes and dtypes equal the reference's ShapeDtypeStructs,
    the specs equal its PartitionSpecs (at a (1, 1) mesh the port's
    placement is the reference's rule), a rank's stand-ins equal the
    global shapes over the specs, and nothing holds storage."""
    import jax

    from repro.launch import shapes as J
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.launch import shapes as S_
    from repro_torch.models.sharding import spec_leaves

    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    ref = J.input_specs(arch, shape, jmesh, T=2)
    inp = S_.input_specs(arch, shape, one_rank_mesh, T=2)
    kind = S_.SHAPES[shape].kind
    pkey = "global_params" if kind == "train" else "params"
    glob = inp["_global"]
    _same_structs(glob[pkey], ref[pkey])
    ref_specs = [tuple(s.spec) for s in jax.tree.leaves(
        ref["_param_shardings"], is_leaf=lambda x: hasattr(x, "spec"))]
    specs = spec_leaves(inp["_param_shardings"])
    assert [s + (None,) * (len(r) - len(s)) for s, r in
            zip(specs, ref_specs)] == ref_specs
    for name in ("tokens", "token", "A", "tau", "m", "eta", "prefix"):
        if name in ref:
            assert tuple(glob[name].shape) == tuple(ref[name].shape)
            assert glob[name].dtype == getattr(torch, str(ref[name].dtype))
            assert tuple(inp[name].shape) == tuple(ref[name].shape)
    if kind == "decode":
        _same_structs(glob["cache"], ref["cache"])
        got = [tuple(s) for s in spec_leaves(inp["_cache_shardings"])]
        want = [tuple(s.spec) for s in jax.tree.leaves(
            ref["_cache_shardings"], is_leaf=lambda x: hasattr(x, "spec"))]
        assert [g + (None,) * (len(w) - len(g)) for g, w in
                zip(got, want)] == want
        _same_structs(inp["cache"], ref["cache"])
        assert isinstance(inp["pos"], int)
    if kind != "train":
        assert inp["_batch_axes"] == ref["_batch_axes"]
    else:
        assert inp["_client_spec"] == (("data",),)
    # a rank holds the whole leaves at (1, 1)
    _same_structs(inp[pkey], ref[pkey])
    stand_ins = [x for k, v in inp.items() if not k.startswith("_")
                 for x in tree_leaves(v) if isinstance(x, torch.Tensor)]
    assert stand_ins and all(_abstract(x) for x in stand_ins)


def test_local_shapes_are_global_over_the_spec(one_rank_mesh):
    """At a 'model' axis above 1 (a stand-in mesh object: shapes only)
    each leaf's local dims are its global dims over the axes its spec
    names, and ZeRO adds 'data' on the global copy's split dim."""
    from repro_torch.configs import get_config
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.launch import shapes as S_
    from repro_torch.models.sharding import spec_leaves

    class Mesh:
        mesh_dim_names = ("data", "model")
        shape = (2, 4)

    cfg = S_.production_config(get_config("qwen2-7b"), S_.SHAPES["train_4k"])
    from repro_torch.models.model import Model
    for zero in (False, True):
        whole, specs = S_.param_structs(Model(cfg, device="meta"), Mesh,
                                        zero=zero)
        local = S_._local(whole, specs, Mesh, "meta")
        n_split = 0
        for w, s, x in zip(tree_leaves(whole), spec_leaves(specs),
                           tree_leaves(local)):
            want = tuple(d // (4 if a == "model" else 2 if a == "data"
                               else 1) for d, a in zip(w.shape, s))
            assert tuple(x.shape) == want and x.is_meta
            n_split += "model" in s
            assert ("data" in s) == (zero and "data" in s)
        assert n_split > 0


# ---------------------------------------------------------------------------
# op_cost: twins of the reference's jaxpr_cost tests
# ---------------------------------------------------------------------------

def test_op_cost_matmul_exact():
    from repro_torch.roofline import cost_of
    a = torch.empty((64, 128), device="meta")
    b = torch.empty((128, 32), device="meta")
    c = cost_of(lambda x, y: x @ y, a, b)
    assert c["flops"] == 2 * 64 * 128 * 32
    assert c["bytes"] == (64 * 128 + 128 * 32 + 64 * 32) * 4
    assert c["unknown_while"] == 0


def test_op_cost_loop_multiplies_trips():
    """The reference's scan of 7 matmuls: the port's Python loop runs
    unrolled, each trip counted."""
    from repro_torch.roofline import cost_of

    def f(x, w):
        for wi in w:
            x = x @ wi
        return x

    x = torch.empty((16, 16), device="meta")
    w = torch.empty((7, 16, 16), device="meta")
    assert cost_of(f, x, w)["flops"] == 7 * 2 * 16 ** 3


def test_op_cost_counts_remat_recompute():
    from repro_torch.models.remat import remat
    from repro_torch.roofline import cost_of

    def loss(w, x):
        h, = remat(lambda p, a: (torch.tanh(a @ p["w"]),), {"w": w}, x)
        return torch.sum(h @ w)

    def loss_noremat(w, x):
        return torch.sum(torch.tanh(x @ w) @ w)

    w = torch.randn(32, 32)
    x = torch.randn(8, 32)
    base = cost_of(loss, w, x)
    plain = cost_of(loss_noremat, w, x)
    g_remat = cost_of(torch.func.grad(loss), w, x)
    g_plain = cost_of(torch.func.grad(loss_noremat), w, x)
    assert base["flops"] == plain["flops"]
    assert g_remat["flops"] > g_plain["flops"]      # recompute counted
    # exactly: the recomputed a @ w, and the gradient of the body's input
    # a, which the remat backward forms (it differentiates every floating
    # input of the body) and the plain backward skips (x needs none)
    assert g_remat["flops"] == g_plain["flops"] + 2 * (2 * 8 * 32 * 32)


def test_grouped_mm_counts_the_reference_ragged_dot():
    """``aten._grouped_mm`` at 2 x rows x K x N, the reference's
    ``ragged_dot`` formula (``jaxpr_cost._ragged_dot_flops``), whatever
    the offsets; the loop route's per-expert products give the same on
    any split.  (The installed jax names the primitive
    ``ragged_dot_general``, which the reference's walker does not match:
    it counts 0 for it, so the pin is the formula on the traced eqn.)"""
    import jax
    import jax.numpy as jnp

    from repro.roofline.jaxpr_cost import _ragged_dot_flops, jaxpr_cost
    from repro_torch.roofline import cost_of
    from torch._subclasses.fake_tensor import FakeTensorMode

    rows, d, ff, E = 48, 16, 24, 4
    closed = jax.make_jaxpr(lambda x, w, g: jax.lax.ragged_dot(x, w, g))(
        jax.ShapeDtypeStruct((rows, d), jnp.bfloat16),
        jax.ShapeDtypeStruct((E, d, ff), jnp.bfloat16),
        jax.ShapeDtypeStruct((E,), jnp.int32))
    eqn, = closed.jaxpr.eqns
    want = _ragged_dot_flops(eqn)
    assert want == 2 * rows * d * ff
    assert jaxpr_cost(closed)["flops"] == 0     # the walker's blind spot
    with FakeTensorMode():
        xs = torch.empty((rows, d), dtype=torch.bfloat16)
        w = torch.empty((E, d, ff), dtype=torch.bfloat16)
        offs = torch.empty((E,), dtype=torch.int32)
        got = cost_of(lambda: torch.nn.functional.grouped_mm(xs, w,
                                                            offs=offs))
    assert got["flops"] == want
    loop = cost_of(lambda: [torch.empty((n, d), device="meta")
                            @ torch.empty((d, ff), device="meta")
                            for n in (5, 0, 30, 13)])
    assert loop["flops"] == want


def test_bytes_count_the_reference_classes_only():
    from repro_torch.roofline import cost_of
    x = torch.empty((8, 16), device="meta")
    idx = torch.empty((4,), dtype=torch.int64, device="meta")
    nb = 8 * 16 * 4
    assert cost_of(lambda: torch.tanh(x) * 2 + x)["bytes"] == 0
    assert cost_of(lambda: torch.maximum(x, x))["bytes"] == 0
    c = cost_of(lambda: (x.sum(1), x.amax(0), torch.max(x, 1),
                         torch.softmax(x, -1), torch.cumsum(x, 0),
                         torch.cat([x, x]), torch.topk(x, 2),
                         torch.sort(x, 1), x[idx],
                         x.index_add(0, idx, x[:4])))
    f4, i8 = 4, 8                  # fp32 values, int64 indices
    assert c["bytes_by_class"] == {
        # operands + results: sum(1), amax(0), max(1) (values and
        # indices), softmax, cumsum
        "reduce": (nb + 8 * f4) + (nb + 16 * f4) + (nb + 8 * (f4 + i8))
        + 2 * nb + 2 * nb,
        "concat": 2 * nb + 2 * nb,
        # topk(2) and sort: values and indices
        "sort": (nb + 8 * 2 * (f4 + i8)) + (nb + nb + 8 * 16 * i8),
        "gather": nb + 4 * i8 + 4 * 16 * f4,
        "scatter": nb + 4 * i8 + 4 * 16 * f4 + nb}


# ---------------------------------------------------------------------------
# FLOPs of each arch against the reference's jaxpr count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["forward", "grad"])
@pytest.mark.parametrize("arch", _archs())
def test_flops_match_the_references_jaxpr_count(arch, what):
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as j_get_config
    from repro.models.model import Model as JModel
    from repro.roofline.jaxpr_cost import cost_of_lowered
    from repro_torch.configs import get_config
    from repro_torch.launch.shapes import _meta
    from repro_torch.models.model import Model
    from repro_torch.roofline import cost_of
    from torch._subclasses.fake_tensor import FakeTensorMode

    Bq, K = 2, 32
    jcfg, cfg = j_get_config(arch, reduced=True), get_config(arch,
                                                            reduced=True)
    jm, m = JModel(jcfg), Model(cfg, device="meta")
    jp = jax.eval_shape(jm.init, jax.random.key(0))
    with FakeTensorMode():
        fake = Model(cfg, device="cpu").init(torch.Generator())
    tp = _meta(fake)
    P = cfg.frontend_len if cfg.frontend else 0
    jt = jax.ShapeDtypeStruct((Bq, K), jnp.int32)
    je = jax.ShapeDtypeStruct((Bq, P, cfg.frontend_dim), jnp.float32) \
        if cfg.frontend else None
    tt = torch.empty((Bq, K), dtype=torch.int32, device="meta")
    te = torch.empty((Bq, P, cfg.frontend_dim), device="meta") \
        if cfg.frontend else None
    if what == "forward":
        want = cost_of_lowered(jm.forward, jp, jt, je)["flops"]
        got = cost_of(m.forward, tp, tt, te)["flops"]
    else:
        jb = (jt, jt) + ((je,) if je is not None else ())
        tb = (tt, tt) + ((te,) if te is not None else ())
        want = cost_of_lowered(lambda p, b: jax.grad(jm.loss)(p, b), jp,
                               jb)["flops"]
        got = cost_of(torch.func.grad(m.loss), tp, tb)["flops"]
    assert want > 0 and abs(got / want - 1) < 0.02


# ---------------------------------------------------------------------------
# roofline arithmetic
# ---------------------------------------------------------------------------

HLO = """
HloModule test

ENTRY %main (a: f32[8]) -> f32[8] {
  %ar = f32[8]{0} all-reduce(%a), replica_groups={}
  %cp = f32[16]{0} collective-permute(%a), source_target_pairs={{0,1}}
  ROOT %out = f32[8] copy(%ar)
}
"""


@pytest.mark.parametrize("kind,arch", [
    ("train", "qwen2-7b"), ("prefill", "phi3.5-moe-42b-a6.6b"),
    ("decode", "mamba2-1.3b"), ("decode", "deepseek-v2-236b")])
def test_roofline_report_is_the_references_arithmetic(kind, arch):
    from repro.configs import get_config as j_get_config
    from repro.roofline import roofline as J
    from repro_torch.configs import get_config
    from repro_torch.roofline import HW, model_flops, roofline_report

    v5e = J.HW()
    hw = HW(peak_flops=v5e.peak_flops, hbm_bw=v5e.hbm_bw,
            hbm_bytes=v5e.hbm_bytes, model_link_bw=v5e.ici_bw,
            client_link_bw=v5e.ici_bw)
    kw = dict(arch=arch, shape="s", mesh="16x16", chips=256,
              flops_global=3.1e18, bytes_global=7.7e15, kind=kind,
              tokens=123456, peak_memory=5e9)
    ref = J.roofline_report(hlo_text=HLO, cfg=j_get_config(arch), **kw)
    coll = {"collectives": {"all-reduce": 32, "recv": 64},
            "collectives_by_axis": {"model": 32, "data": 64},
            "unknown_while": 0}
    got = roofline_report(collectives=coll, cfg=get_config(arch), hw=hw,
                          **kw)
    want = ref.as_dict()
    have = got.as_dict()
    assert have.pop("collective_per_axis") == {"model": 32, "data": 64}
    assert have.pop("collective_per_device") == {"all-reduce": 32,
                                                  "recv": 64}
    want.pop("collective_per_device")
    assert have == want
    for k in ("train", "prefill", "decode"):
        assert model_flops(get_config(arch), k, 1000) == \
            J.model_flops(j_get_config(arch), k, 1000)


def test_h100_constants_and_links():
    from repro_torch.roofline import H100, HW, collective_bytes
    assert (H100.peak_flops, H100.hbm_bw, H100.hbm_bytes,
            H100.model_link_bw, H100.client_link_bw) == \
        (989e12, 3.35e12, 80e9, 450e9, 50e9)
    assert H100 == HW()
    assert H100.link_bw("model") == 450e9
    assert H100.link_bw("data") == H100.link_bw("pod,data") == \
        H100.link_bw("data,model") == 50e9
    assert collective_bytes({"collectives": {"all-reduce": 8.0}}) == \
        {"all-reduce": 8}


# ---------------------------------------------------------------------------
# the repairs the abstract run needs, and the CLI
# ---------------------------------------------------------------------------

def test_fake_world_repairs(one_rank_mesh, monkeypatch):
    import torch.distributed as dist

    from repro_torch.fl import distributed as D
    from repro_torch.models import moe, sharding

    class CudaMesh:
        device_type = "cuda"

    def no_cuda():
        raise AssertionError("touched CUDA")

    monkeypatch.setattr(torch.cuda, "current_device", no_cuda)
    assert D.mesh_device(CudaMesh()) == torch.device("cuda", 0)
    group = dist.group.WORLD
    assert sharding.seq_route(group, torch.empty(2, device="meta")) == \
        "collective"
    assert D.batch_rows(one_rank_mesh, None, 3) == slice(0, 3)
    sizes = torch.empty((5,), dtype=torch.int64, device="meta")
    assert moe._host_sizes(sizes, 12) == [3, 3, 2, 2, 2]
    assert moe._host_sizes(torch.tensor([4, 0, 8]), 12) == [4, 0, 8]


def _cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args],
        capture_output=True, text=True, timeout=timeout, env=_env(),
        cwd=str(HERE.parents[1]))


def test_dryrun_cli_writes_artifact(tmp_path):
    """The twin of the reference's ``tests/test_distributed.py:99``."""
    out = str(tmp_path / "dry")
    r = _cli("--arch", "stablelm-1.6b", "--shape", "decode_32k",
                "--mesh", "2,4", "--out", out)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK   stablelm-1.6b")
    path = os.path.join(out, "stablelm-1.6b__decode_32k__2x4.json")
    with open(path) as f:
        rec = json.load(f)
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["flops_per_device"] > 0
    assert rec["bytes_per_device"] > 0
    assert rec["chips"] == 8
    assert rec["collective_per_axis"]["model"] > 0
    assert rec["unknown_loops"] == 0 and rec["mixing"] is None
    assert rec["memory_analysis"]["peak_bytes"] >= \
        rec["memory_analysis"]["argument_size_in_bytes"] > 0
    assert rec["n_collective_ops"] == sum(rec["collective_ops"].values())


def test_dryrun_production_world_and_failures(tmp_path):
    out = str(tmp_path / "dry")
    r = _cli("--arch", "qwen2-7b", "--shape", "long_500k", "--out", out,
                "--tag", "t")
    assert r.returncode == 0, r.stdout + r.stderr
    with open(os.path.join(out, "qwen2-7b__long_500k__16x16__t.json")) as f:
        rec = json.load(f)
    assert rec["chips"] == 256 and rec["mesh"] == "16x16"
    # 28 q / 4 kv heads do not split 16 ways: attention runs whole, the
    # MLP's all-reduces run over the node's 16 ranks
    assert set(rec["collective_per_axis"]) == {"model"}
    # a combination that cannot run fails loudly; nothing runs instead
    r = _cli("--arch", "stablelm-1.6b", "--shape", "train_4k", "--mesh",
                "3,1", "--out", out)
    assert r.returncode == 1
    assert r.stdout.startswith("FAIL stablelm-1.6b")
    assert "not divisible by n_clients 3" in r.stderr


if __name__ == "__main__" and sys.argv[1:2] in (["worker"], ["fake"]):
    sys.path.insert(0, str(SRC))
    _tally_worker(sys.argv[1], int(sys.argv[2]), Path(sys.argv[3]),
                  sys.argv[4].split(","))
