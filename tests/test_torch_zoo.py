"""The port's MoE, MLA, SSD and hybrid modules (``repro_torch.models.moe``,
``mla``, ``ssm``, ``blocks``) against the JAX package's, and the port's
twins of the reference's pins on them.

Parameters come from the reference's ``*_init`` (a JAX key) and are
carried into the port through numpy; inputs are drawn from a numpy
seed; both packages compute on the CPU.  Tolerances, fp32:

* module outputs against the reference: rtol = atol = 1e-5 (fp32 ops in
  another order); caches and states after decode steps: 1e-4, the
  reference's own for a model path (``tests/test_kernels.py:112-129``);
* routing ids: equal (a mismatch is reported with its probability gap);
* the twins: the reference's own tolerances, named at each test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import mla as j_mla
from repro.models import moe as j_moe
from repro.models import ssm as j_ssm
from repro.models.config import ModelConfig as JConfig
from repro.models.model import Model as JModel
from repro_torch.configs import get_config
from repro_torch.models import mla, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model

F32 = dict(rtol=1e-5, atol=1e-5)
MODEL = dict(rtol=1e-4, atol=1e-4)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _cfgs(**kw):
    """The same config in both packages."""
    return JConfig(**kw), ModelConfig(**kw)


def _x(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_kw(impl, E=4, k=2, shared=1, chunk=0, d=32):
    return dict(name="t", family="moe", n_layers=1, d_model=d, n_heads=2,
                n_kv_heads=2, d_ff=64, vocab_size=7, n_experts=E,
                experts_per_token=k, n_shared_experts=shared, moe_d_ff=48,
                moe_impl=impl, moe_chunk=chunk)


def _assert_same_ids(jcfg, jp, cfg, tp, x):
    """The port's router picks the reference's experts; a mismatch names
    the token and the gap between the probabilities it hinged on."""
    xf = x.reshape(-1, x.shape[-1])
    _, jids, jaux = j_moe._route(jcfg, jp, jnp.asarray(xf))
    _, ids, aux = moe._route(cfg, tp, torch.as_tensor(xf))
    jids = np.asarray(jids)
    bad = np.nonzero((jids != ids.numpy()).any(-1))[0]
    if len(bad):
        probs = torch.softmax(torch.as_tensor(xf).float() @ tp["router"], -1)
        t = int(bad[0])
        top = torch.sort(probs[t], descending=True).values.numpy()
        k = jids.shape[1]
        gap = top[k - 1] - top[k] if k < len(top) else float("inf")
        pytest.fail(f"token {t}: port ids {ids[t].tolist()}, reference "
                    f"{jids[t].tolist()}; the k-th / (k+1)-th probability "
                    f"gap {gap:.3e}")
    _close(aux, jaux, F32)


MOE_CASES = [
    # (impl, E, k, shared, chunk, seed)
    ("dense", 4, 2, 1, 0, 0), ("ragged", 4, 2, 1, 0, 0),
    ("ragged", 4, 1, 0, 0, 1), ("ragged", 4, 3, 1, 0, 2),
    ("ragged", 16, 6, 2, 0, 3),            # deepseek's top-6 + 2 shared
    ("ragged", 16, 6, 2, 4, 4),            # token-chunked dispatch
    ("dense", 16, 6, 2, 0, 5),
]


@pytest.mark.parametrize("impl,E,k,shared,chunk,seed", MOE_CASES)
def test_moe_apply_matches_the_reference(impl, E, k, shared, chunk, seed):
    jcfg, cfg = _cfgs(**_moe_kw(impl, E, k, shared, chunk))
    jp = j_moe.moe_init(jax.random.key(seed), jcfg, jnp.float32)
    tp = _to_torch(jp)
    assert tp["router"].dtype == torch.float32
    x = _x(seed + 100, (2, 6, 32))
    _assert_same_ids(jcfg, jp, cfg, tp, x)
    jy, jaux = jax.jit(j_moe.moe_apply, static_argnums=0)(
        jcfg, jp, jnp.asarray(x))
    y, aux = moe.moe_apply(cfg, tp, torch.as_tensor(x))
    _close(y, jy, F32)
    _close(aux, jaux, F32)


def test_moe_init_keeps_the_router_fp32_in_a_bf16_model():
    _, cfg = _cfgs(**_moe_kw("ragged", shared=1))
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert p["router"].dtype == torch.float32
    jp = j_moe.moe_init(jax.random.key(0), JConfig(**_moe_kw("ragged")),
                        jnp.bfloat16)
    for name in ("gate", "up", "down"):
        assert p[name].dtype == torch.bfloat16
        assert tuple(p[name].shape) == jp[name].shape
    assert tuple(p["shared"]["gate"].shape) == jp["shared"]["gate"].shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_combine_is_bitwise_reproducible(dtype):
    """Two calls of the ragged path on the same input give the same bits:
    the combine adds the k slots in a fixed order, no scatter-add."""
    _, cfg = _cfgs(**_moe_kw("ragged", E=16, k=6, shared=2))
    p = moe.moe_init(torch.Generator().manual_seed(1), cfg, dtype)
    x = torch.as_tensor(_x(7, (3, 20, 32))).to(dtype)
    y1, a1 = moe.moe_apply(cfg, p, x)
    y2, a2 = moe.moe_apply(cfg, p, x)
    assert torch.equal(y1, y2) and torch.equal(a1, a2)


def test_expert_route_is_fixed_by_dtype_and_device():
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert moe.expert_route(torch.bfloat16, cuda) == "grouped_mm"
    assert moe.expert_route(torch.float32, cuda) == "loop"
    assert moe.expert_route(torch.bfloat16, cpu) == "loop"
    _, cfg = _cfgs(**_moe_kw("ragged", E=4, k=2, shared=0))
    p = moe.moe_init(torch.Generator().manual_seed(2), cfg, torch.float32)
    x = torch.as_tensor(_x(8, (1, 16, 32)))
    before = dict(moe.expert_matmul.routes)
    moe.moe_apply(cfg, p, x)
    _, ids, _ = moe._route(cfg, p, x.reshape(16, 32))
    used = len(torch.unique(ids))
    assert moe.expert_matmul.routes["grouped_mm"] == before["grouped_mm"]
    assert moe.expert_matmul.routes["loop"] == before["loop"] + 3 * used


def test_expert_matmul_routes_agree():
    """``grouped_mm`` (here on the CPU, where the library runs it too) and
    the per-expert loop compute the same grouped product in bf16."""
    g = torch.Generator().manual_seed(3)
    sizes = torch.tensor([5, 0, 9, 2])
    xs = torch.randn(16, 32, generator=g).bfloat16()
    w = torch.randn(4, 32, 24, generator=g).bfloat16()
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    loop = moe.expert_matmul(xs, w, sizes, offs)
    lib = torch.nn.functional.grouped_mm(xs, w, offs=offs)
    _close(lib, loop, dict(rtol=2 ** -7, atol=2 ** -7))


# twins of tests/test_model_components.py:92, 104, 120

@pytest.mark.parametrize("seed,k", [(0, 1), (1, 2), (2, 3), (3, 2), (5, 1)])
def test_moe_ragged_matches_dense(seed, k):
    """Twin of ``test_moe_ragged_matches_dense`` (rtol = atol = 2e-4; aux
    rtol 1e-5)."""
    _, cfg_d = _cfgs(**_moe_kw("dense", k=k))
    cfg_r = dataclasses.replace(cfg_d, moe_impl="ragged")
    p = moe.moe_init(torch.Generator().manual_seed(seed), cfg_d,
                     torch.float32)
    x = torch.as_tensor(_x(seed + 100, (2, 6, 32)))
    yd, auxd = moe.moe_apply(cfg_d, p, x)
    yr, auxr = moe.moe_apply(cfg_r, p, x)
    _close(yr, yd, dict(rtol=2e-4, atol=2e-4))
    np.testing.assert_allclose(float(auxr), float(auxd), rtol=1e-5)


def test_moe_ragged_grads_match_dense():
    """Twin of ``test_moe_ragged_grads_match_dense`` through autograd
    (rtol = atol = 5e-4)."""
    _, cfg_d = _cfgs(**_moe_kw("dense"))
    cfg_r = dataclasses.replace(cfg_d, moe_impl="ragged")
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg_d, torch.float32)
    x = torch.as_tensor(_x(1, (1, 8, 32)))

    def grads(cfg):
        q = {k: (v.clone().requires_grad_(True) if isinstance(v, torch.Tensor)
                 else {kk: vv.clone().requires_grad_(True)
                       for kk, vv in v.items()}) for k, v in p.items()}
        y, aux = moe.moe_apply(cfg, q, x)
        ((y ** 2).sum() + aux).backward()
        flat = [q[k] for k in ("down", "gate", "router", "up")]
        return [t.grad for t in flat] + [q["shared"][k].grad
                                         for k in ("down", "gate", "up")]

    for a, b in zip(grads(cfg_d), grads(cfg_r)):
        _close(b, a, dict(rtol=5e-4, atol=5e-4))


def test_moe_aux_loss_balanced_router_is_one():
    """Twin of ``test_moe_aux_loss_balanced_router_is_one``: a zero router
    gives uniform probabilities and aux = 1 (rel 1e-5)."""
    _, cfg = _cfgs(**_moe_kw("dense", E=4, k=1, shared=0))
    p = moe.moe_init(torch.Generator().manual_seed(0), cfg, torch.float32)
    p["router"] = torch.zeros_like(p["router"])
    _, aux = moe.moe_apply(cfg, p, torch.as_tensor(_x(1, (1, 16, 32))))
    assert float(aux) == pytest.approx(1.0, rel=1e-5)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_kw(q_lora=0, **kw):
    base = dict(name="t", family="moe", n_layers=1, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=128, vocab_size=7, n_experts=4,
                experts_per_token=2, moe_d_ff=32, mla=True, kv_lora_rank=32,
                q_lora_rank=q_lora, rope_head_dim=16, nope_head_dim=16,
                v_head_dim=16, attn_chunk=16)
    base.update(kw)
    return base


@pytest.mark.parametrize("impl", ["ref", "chunked", "flash"])
@pytest.mark.parametrize("q_lora,window", [(0, None), (48, None), (0, 20)])
def test_mla_full_matches_the_reference(q_lora, window, impl):
    """Full, query-chunked (a ragged last chunk: 40 = 2 x 16 + 8) and
    'flash' (no flash branch in MLA: the full path)."""
    jcfg, cfg = _cfgs(**_mla_kw(q_lora, attn_impl=impl,
                                sliding_window=window))
    jp = j_mla.mla_init(jax.random.key(0), jcfg, jnp.float32)
    x, pos = _x(1, (2, 40, 64)), np.arange(40)
    want = jax.jit(j_mla.mla_full, static_argnums=0)(
        jcfg, jp, jnp.asarray(x), jnp.asarray(pos))
    got = mla.mla_full(cfg, _to_torch(jp), torch.as_tensor(x),
                       torch.as_tensor(pos))
    _close(got, want, F32)


@pytest.mark.parametrize("q_lora,W,window", [(0, 24, None), (48, 8, 8)])
def test_mla_decode_matches_the_reference(q_lora, W, window):
    """20 decode steps through the absorbed latent cache: each output and
    the final ring (``ckv`` / ``krope`` / ``kpos``, wrapping twice when
    W = 8) equal the reference's."""
    jcfg, cfg = _cfgs(**_mla_kw(q_lora, sliding_window=window))
    jp = j_mla.mla_init(jax.random.key(1), jcfg, jnp.float32)
    tp = _to_torch(jp)
    x = _x(2, (2, 20, 64))
    jc = jax.tree.map(lambda a: a[0],
                      j_mla.make_mla_cache(jcfg, 2, W, 1, jnp.float32))
    tc = {k: v[0] for k, v in mla.make_mla_cache(
        cfg, 2, W, 1, torch.float32).items()}
    for t in range(20):
        jy, jc = j_mla.mla_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jc,
                                  jnp.asarray(t, jnp.int32))
        ty, tc = mla.mla_decode(cfg, tp, torch.as_tensor(x[:, t:t + 1]), tc,
                                t)
        _close(ty, jy, MODEL)
    for name in ("ckv", "krope"):
        _close(tc[name], jc[name], MODEL)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))


def test_mla_decode_matches_full_attention():
    """The absorbed decode reproduces the full-sequence path (1e-4)."""
    _, cfg = _cfgs(**_mla_kw(48))
    p = mla.mla_init(torch.Generator().manual_seed(4), cfg, torch.float32)
    x = torch.as_tensor(_x(3, (1, 12, 64)))
    full = mla.mla_full(cfg, p, x, torch.arange(12))
    cache = {k: v[0] for k, v in mla.make_mla_cache(
        cfg, 1, 12, 1, torch.float32).items()}
    ys = [mla.mla_decode(cfg, p, x[:, t:t + 1], cache, t)[0]
          for t in range(12)]
    _close(torch.cat(ys, 1), full, MODEL)


def test_chunked_mla_matches_full():
    """Twin of ``tests/test_perf_paths.py:68``: deepseek-v2 reduced with
    attn_impl='chunked', chunk 16, on 72 tokens (rtol = atol = 2e-3)."""
    cfg = get_config("deepseek-v2-236b", reduced=True)
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 72)))
    lr, _ = m.forward(params, toks)
    lc, _ = Model(dataclasses.replace(cfg, attn_impl="chunked",
                                      attn_chunk=16),
                  device="cpu").forward(params, toks)
    _close(lc, lr, dict(rtol=2e-3, atol=2e-3))


# ---------------------------------------------------------------------------
# SSD (mamba2)
# ---------------------------------------------------------------------------

def _ssm_kw(chunk=8, state=8, head_dim=8, d_model=32, groups=1):
    return dict(name="t", family="ssm", n_layers=1, d_model=d_model,
                n_heads=0, n_kv_heads=0, d_ff=0, vocab_size=7,
                ssm_state=state, ssm_head_dim=head_dim, ssm_chunk=chunk,
                ssm_groups=groups)


@pytest.mark.parametrize("L,chunk,groups", [(16, 8, 1), (19, 8, 1),
                                            (21, 16, 2), (3, 8, 1)])
def test_ssm_forward_and_prefill_match_the_reference(L, chunk, groups):
    """Chunked SSD at a multiple of the chunk and ragged (padded steps
    with dt = 0), one and two B/C groups, a sequence shorter than the
    conv window: output, final fp32 state, conv tail."""
    jcfg, cfg = _cfgs(**_ssm_kw(chunk=chunk, groups=groups))
    jp = j_ssm.ssm_init(jax.random.key(0), jcfg, jnp.float32)
    tp = _to_torch(jp)
    for name in ("dt_bias", "A_log", "D"):
        assert tp[name].dtype == torch.float32
    x = _x(4, (2, L, 32), 0.5)
    jy, jstate, jtail = jax.jit(j_ssm.ssm_prefill, static_argnums=0)(
        jcfg, jp, jnp.asarray(x))
    y, state, tail = ssm.ssm_prefill(cfg, tp, torch.as_tensor(x))
    _close(y, jy, F32)
    _close(ssm.ssm_forward(cfg, tp, torch.as_tensor(x)), jy, F32)
    assert state.dtype == torch.float32
    _close(state, jstate, F32)
    _close(tail, jtail, F32)


def test_ssm_decode_matches_the_reference():
    """12 recurrent steps from the prefill's cache: outputs, conv window
    and state equal the reference's (1e-4)."""
    jcfg, cfg = _cfgs(**_ssm_kw())
    jp = j_ssm.ssm_init(jax.random.key(1), jcfg, jnp.float32)
    tp = _to_torch(jp)
    x = _x(5, (2, 21, 32), 0.5)
    _, jstate, jtail = j_ssm.ssm_prefill(jcfg, jp, jnp.asarray(x[:, :9]))
    jc = {"conv": jtail, "state": jstate}
    _, state, tail = ssm.ssm_prefill(cfg, tp, torch.as_tensor(x[:, :9]))
    tc = {"conv": tail.clone(), "state": state.clone()}
    for t in range(9, 21):
        jy, jc = j_ssm.ssm_decode(jcfg, jp, jnp.asarray(x[:, t:t + 1]), jc)
        ty, tc = ssm.ssm_decode(cfg, tp, torch.as_tensor(x[:, t:t + 1]), tc)
        _close(ty, jy, MODEL)
    _close(tc["conv"], jc["conv"], MODEL)
    _close(tc["state"], jc["state"], MODEL)


def test_ssm_init_matches_the_reference_tree():
    jcfg, cfg = _cfgs(**_ssm_kw(groups=2))
    jp = j_ssm.ssm_init(jax.random.key(0), jcfg, jnp.bfloat16)
    tp = ssm.ssm_init(torch.Generator().manual_seed(0), cfg, torch.bfloat16)
    assert sorted(tp) == sorted(jp)
    for name, a in tp.items():
        assert tuple(a.shape) == jp[name].shape, name
        assert str(a.dtype).split(".")[1] == str(jp[name].dtype), name
    dt0 = torch.nn.functional.softplus(tp["dt_bias"].float())
    assert float(dt0.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt0.max()) <= 1e-1 * (1 + 1e-5)


# twins of tests/test_model_components.py:43, 53, 65

def _naive_ssd(cfg, p, x):
    """Token-by-token recurrence oracle (``ssm_decode``, looped)."""
    B, L, _ = x.shape
    cache = {k: v[0] for k, v in ssm.make_ssm_cache(
        cfg, B, 1, x.dtype).items()}
    ys = []
    for t in range(L):
        y, cache = ssm.ssm_decode(cfg, p, x[:, t:t + 1], cache)
        ys.append(y)
    return torch.cat(ys, 1), cache


def _ssm_pair(chunk=8):
    _, cfg = _cfgs(**_ssm_kw(chunk=chunk))
    return cfg, ssm.ssm_init(torch.Generator().manual_seed(0), cfg,
                             torch.float32)


@pytest.mark.parametrize("L", [8, 16, 24])
def test_ssd_chunked_matches_recurrence(L):
    """Twin of ``test_ssd_chunked_matches_recurrence`` (2e-4)."""
    cfg, p = _ssm_pair()
    x = torch.as_tensor(_x(L, (2, L, 32), 0.5))
    y_naive, _ = _naive_ssd(cfg, p, x)
    _close(ssm.ssm_forward(cfg, p, x), y_naive, dict(rtol=2e-4, atol=2e-4))


def test_ssd_prefill_state_matches_recurrence():
    """Twin of ``test_ssd_prefill_state_matches_recurrence`` (state 2e-4,
    conv tail 1e-5)."""
    cfg, p = _ssm_pair()
    x = torch.as_tensor(_x(2, (1, 19, 32), 0.5))
    _, state, tail = ssm.ssm_prefill(cfg, p, x)
    _, cache = _naive_ssd(cfg, p, x)
    _close(state, cache["state"], dict(rtol=2e-4, atol=2e-4))
    _close(tail, cache["conv"], F32)


def test_ssd_padding_invariance():
    """Twin of ``test_ssd_padding_invariance``: chunks of 4, 8 and 16 on
    12 tokens give one output (2e-4)."""
    cfg, p = _ssm_pair()
    x = torch.as_tensor(_x(3, (1, 12, 32)))
    outs = [ssm.ssm_forward(dataclasses.replace(cfg, ssm_chunk=c), p, x)
            for c in (4, 8, 16)]
    _close(outs[1], outs[0], dict(rtol=2e-4, atol=2e-4))
    _close(outs[2], outs[0], dict(rtol=2e-4, atol=2e-4))


# ---------------------------------------------------------------------------
# the hybrid stack (zamba2's grouped layout)
# ---------------------------------------------------------------------------

def _hybrid_kw(**kw):
    base = dict(name="t", family="hybrid", n_layers=4, d_model=64,
                n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
                vocab_size=97, ssm_state=16, ssm_head_dim=16, ssm_chunk=16,
                hybrid_attn_every=2, remat=False)
    base.update(kw)
    return base


@pytest.mark.parametrize("every", [1, 2, 4])
def test_hybrid_stack_matches_the_reference(every):
    """4 Mamba layers in groups of ``every`` with the shared block after
    each group: forward, prefill (the shared block's KV ring one a
    group), decode, and the caches after it (1e-4)."""
    jcfg, cfg = _cfgs(**_hybrid_kw(hybrid_attn_every=every))
    jm, tm = JModel(jcfg), Model(cfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = _to_torch(jp)
    toks = np.random.default_rng(6).integers(0, 97, (2, 20)).astype(np.int32)
    jl, _ = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    tl, _ = tm.forward(tp, torch.as_tensor(toks))
    _close(tl, jl, MODEL)
    jpre, jc = jax.jit(jm.prefill, static_argnums=3)(
        jp, jnp.asarray(toks[:, :19]), None, 24)
    tpre, tc = tm.prefill(tp, torch.as_tensor(toks[:, :19]), None, 24)
    _close(tpre, jpre, MODEL)
    assert tc["shared"]["k"].shape[0] == 4 // every
    jd, jc = jax.jit(jm.decode)(jp, jc, jnp.asarray(toks[:, 19]),
                                jnp.asarray(19, jnp.int32))
    td, tc = tm.decode(tp, tc, torch.as_tensor(toks[:, 19]), 19)
    _close(td, jd, MODEL)
    _close(td, tl[:, 19], dict(rtol=2e-3, atol=2e-3))
    for name in ("k", "v"):
        _close(tc["shared"][name], jc["shared"][name], MODEL)
    np.testing.assert_array_equal(tc["shared"]["kpos"].numpy(),
                                  np.asarray(jc["shared"]["kpos"]))
    for name in ("conv", "state"):
        _close(tc["layers"][name], jc["layers"][name], MODEL)
    fresh = tm.init_cache(2, 24)
    assert {k: tuple(v.shape) for k, v in fresh["shared"].items()} == \
        {k: tuple(v.shape) for k, v in tc["shared"].items()}
    assert {k: tuple(v.shape) for k, v in fresh["layers"].items()} == \
        {k: tuple(v.shape) for k, v in tc["layers"].items()}


def test_hybrid_layers_must_fill_whole_groups():
    _, cfg = _cfgs(**_hybrid_kw(n_layers=3))
    m = Model(cfg, device="cpu")
    p = m.init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="multiple of hybrid_attn_every"):
        m.forward(p, torch.zeros((1, 4), dtype=torch.long))
    with pytest.raises(ValueError, match="multiple of hybrid_attn_every"):
        m.init_cache(1, 8)


def test_zamba2_flash_at_head_dim_80_equals_ref():
    """zamba2's shared block at its full head dim 80 with attn_impl='flash'
    (the kernel's plain version on the CPU) gives the 'ref' logits (1e-4)."""
    cfg = dataclasses.replace(get_config("zamba2-2.7b", reduced=True),
                              head_dim=80)
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    assert params["decoder"]["shared"]["attn"]["q"]["w"].shape[1] == \
        cfg.n_heads * 80
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 24)))
    want, _ = m.forward(params, toks)
    got, _ = Model(dataclasses.replace(cfg, attn_impl="flash"),
                   device="cpu").forward(params, toks)
    _close(got, want, MODEL)


# ---------------------------------------------------------------------------
# whole models on their ragged MoE path, and the dense-layer caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,chunk", [("phi3.5-moe-42b-a6.6b", 0),
                                        ("deepseek-v2-236b", 16)])
def test_ragged_moe_models_match_the_reference(arch, chunk):
    """The reduced configs use the dense oracle; here moe_impl='ragged'
    (and deepseek's token chunks): logits, aux, loss with its aux term,
    prefill and decode (1e-4), the first dense layer's own cache."""
    jcfg = dataclasses.replace(j_get_config(arch, reduced=True),
                               moe_impl="ragged", moe_chunk=chunk)
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              moe_impl="ragged", moe_chunk=chunk)
    jm, tm = JModel(jcfg), Model(cfg, device="cpu")
    jp = jm.init(jax.random.key(0))
    tp = _to_torch(jp)
    rng = np.random.default_rng(8)
    toks = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    jl, jaux = jax.jit(jm.forward)(jp, jnp.asarray(toks))
    tl, aux = tm.forward(tp, torch.as_tensor(toks))
    _close(tl, jl, MODEL)
    _close(aux, jaux, MODEL)
    _close(tm.loss(tp, (torch.as_tensor(toks), torch.as_tensor(tgts))),
           jax.jit(jm.loss)(jp, (jnp.asarray(toks), jnp.asarray(tgts))),
           MODEL)
    jpre, jc = jax.jit(jm.prefill, static_argnums=3)(
        jp, jnp.asarray(toks[:, :31]), None, 36)
    tpre, tc = tm.prefill(tp, torch.as_tensor(toks[:, :31]), None, 36)
    _close(tpre, jpre, MODEL)
    jd, jc = jax.jit(jm.decode)(jp, jc, jnp.asarray(toks[:, 31]),
                                jnp.asarray(31, jnp.int32))
    td, tc = tm.decode(tp, tc, torch.as_tensor(toks[:, 31]), 31)
    _close(td, jd, MODEL)
    if cfg.first_dense_layers:
        (dc,), (jdc,) = tc["dense_layers"], jc["dense_layers"]
        assert sorted(dc) == ["ckv", "kpos", "krope"]
        _close(dc["ckv"], jdc["ckv"], MODEL)
        np.testing.assert_array_equal(dc["kpos"].numpy(),
                                      np.asarray(jdc["kpos"]))
        fresh = tm.init_cache(2, 36)["dense_layers"][0]
        assert {k: tuple(v.shape) for k, v in fresh.items()} == \
            {k: tuple(v.shape) for k, v in dc.items()}
