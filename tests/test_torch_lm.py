"""The port's LM stack (``repro_torch.models``, ``repro_torch.configs``,
``repro_torch.launch.serve``) against the JAX package's.

The reference's parameters (``Model.init`` from a JAX key) are carried
into the port through numpy (``models.convert.params_from_numpy``), the
inputs are drawn from a numpy seed, and both packages compute on the CPU.
Tolerances, fp32 unless named:

* layers: rtol = atol = 1e-5 (fp32 ops in another order); bf16 outputs
  2**-7 (one bf16 ulp: the fp32 intermediate may round to the other
  neighbour);
* attention and whole-model logits, prefill and decode: rtol = atol =
  1e-4, the reference's own for a model attention path
  (``tests/test_kernels.py:112-129``);
* the port's pins (prefill/decode vs forward): 2e-3, the reference's own
  (``tests/test_arch_smoke.py:94-104``);
* bf16 qwen2-7b logits: rtol 2e-2 (the reference's bf16 attention
  tolerance) and atol 6e-2, two bf16 ulps at the logits' scale (|logit|
  <= 4.5 here, ulp 2**-5): activations are rounded to bf16 after every
  op, at places that differ between XLA and PyTorch;
* greedy tokens: equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro.models import layers as j_layers
from repro.models.model import Model as JModel
from repro_torch.configs import arch_names, get_config
from repro_torch.core.pytree import tree_flatten
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.launch import serve
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model

ARCHS = ["qwen2-7b", "qwen3-32b", "qwen1.5-4b", "stablelm-1.6b",
         "musicgen-large", "internvl2-1b", "phi3.5-moe-42b-a6.6b",
         "deepseek-v2-236b", "mamba2-1.3b", "zamba2-2.7b"]
F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2 ** -7, atol=2 ** -7)
MODEL = dict(rtol=1e-4, atol=1e-4)
PIN = dict(rtol=2e-3, atol=2e-3)
B, K, N_NEW, CHUNK = 2, 32, 4, 16


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


def _to_torch(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def _inputs(cfg, seed, batch=B, seq=K):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    tgts = rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
    pe = None
    if cfg.frontend:
        pe = rng.standard_normal(
            (batch, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32)
    return toks, tgts, pe


def _j(a):
    return None if a is None else jnp.asarray(a)


def _t(a):
    return None if a is None else torch.as_tensor(a)


@functools.lru_cache(maxsize=None)
def _pair(arch, dtype="float32"):
    """(port model, port params, reference outputs) of the reduced
    ``arch`` (with ``loss_chunk`` set, so that ``loss`` can take either
    path), from the same weights and inputs."""
    jcfg = dataclasses.replace(j_get_config(arch, reduced=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, reduced=True), dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(0))
    toks, tgts, pe = _inputs(cfg, 1)
    P = cfg.frontend_len if cfg.frontend else 0
    out = {"toks": toks, "tgts": tgts, "pe": pe, "P": P}
    out["logits"], out["aux"] = jax.jit(jm.forward)(jp, _j(toks), _j(pe))
    batch = (_j(toks), _j(tgts)) + ((_j(pe),) if pe is not None else ())
    out["loss"] = jax.jit(jm.loss)(jp, batch)
    out["loss_chunk"] = jax.jit(JModel(dataclasses.replace(
        jcfg, loss_chunk=CHUNK)).loss)(jp, batch)
    out["prefill"], cache = jax.jit(jm.prefill, static_argnums=3)(
        jp, _j(toks[:, :K - 1]), _j(pe), P + K + 4)
    out["decode"], _ = jax.jit(jm.decode)(jp, cache, _j(toks[:, K - 1]),
                                          jnp.asarray(P + K - 1, jnp.int32))
    out["generate"] = jm.generate(jp, _j(toks[:, :16]), N_NEW, _j(pe))
    return Model(cfg, device="cpu"), _to_torch(jp), out


def _batch(ref):
    b = (_t(ref["toks"]), _t(ref["tgts"]))
    return b + ((_t(ref["pe"]),) if ref["pe"] is not None else ())


# ---------------------------------------------------------------------------
# configs and the parameter tree
# ---------------------------------------------------------------------------

def test_config_registry_matches_the_reference():
    from repro.configs import arch_names as j_arch_names
    assert arch_names() == j_arch_names()
    for name in arch_names():
        for reduced in (False, True):
            assert dataclasses.asdict(get_config(name, reduced)) == \
                dataclasses.asdict(j_get_config(name, reduced))
            assert get_config(name, reduced).param_count() == \
                j_get_config(name, reduced).param_count()
    with pytest.raises(KeyError):
        get_config("nope")


@pytest.mark.parametrize("arch", ARCHS)
def test_reference_params_carry_across_as_the_ports_own_tree(arch):
    """``params_from_numpy`` carries a JAX param tree over unchanged, and
    it is the tree the port's ``init`` builds: same keys, shapes, dtypes
    (stacked layer leaves with a leading n_layers axis)."""
    model, params, _ = _pair(arch)
    own = model.init(torch.Generator().manual_seed(0))
    (a, da), (b, db) = tree_flatten(params), tree_flatten(own)
    assert da == db
    assert [(x.shape, x.dtype) for x in a] == [(y.shape, y.dtype) for y in b]
    if arch == "qwen2-7b":
        assert params["decoder"]["layers"]["attn"]["q"]["w"].shape == \
            (2, 256, 128)
        assert params["decoder"]["layers"]["attn"]["q"]["b"].shape == (2, 128)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_norms_match_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32) * 3 + 1
    s = rng.standard_normal(64).astype(np.float32)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    jx, js = jnp.asarray(x, jd), jnp.asarray(s, jd)
    tx, ts = _to_torch(jx), _to_torch(js)
    tol = F32 if dtype == "float32" else BF16
    for kind in ("rms", "layer"):
        got = layers.norm(tx, ts, kind, 1e-6)
        assert got.dtype == td
        _close(got, j_layers.norm(jx, js, kind, 1e-6), tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fraction", [1.0, 0.25])
def test_rope_matches_the_reference(fraction, dtype):
    rng = np.random.default_rng(1)
    hd = 32
    rot = int(hd * fraction) - int(hd * fraction) % 2
    pos = np.arange(40) * 3 + 5
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    jx = jnp.asarray(rng.standard_normal((2, 40, 4, hd)), jd)
    jc, jsn = j_layers.rope_angles(jnp.asarray(pos), rot, 1e6)
    tc, tsn = layers.rope_angles(torch.as_tensor(pos), rot, 1e6)
    _close(tc, jc, F32)
    _close(tsn, jsn, F32)
    got = layers.apply_rope(_to_torch(jx), tc, tsn, fraction)
    _close(got, j_layers.apply_rope(jx, jc, jsn, fraction),
           F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("kind", ["swiglu", "gelu"])
def test_mlps_match_the_reference(kind):
    """SwiGLU, and GELU in its tanh form (``jax.nn.gelu``'s default; the
    exact form differs here by ~70x the tolerance)."""
    jp = j_layers.mlp_init(jax.random.key(0), 64, 192, kind)
    x = np.random.default_rng(2).standard_normal((2, 7, 64)) * 2
    want = j_layers.mlp_apply(jp, jnp.asarray(x, jnp.float32), kind)
    tp = _to_torch(jp)
    tx = torch.as_tensor(x, dtype=torch.float32)
    _close(layers.mlp_apply(tp, tx, kind), want, F32)
    if kind == "gelu":
        exact = torch.nn.functional.gelu(tx @ tp["up"]) @ tp["down"]
        assert np.abs(_np(exact) - _np(want)).max() > 1e-4


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attn_cfg(**kw):
    base = dict(name="t", family="dense", n_layers=1, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=128, vocab_size=7, head_dim=32,
                attn_chunk=32)
    base.update(kw)
    return ModelConfig(**base)


def _attn_pair(**kw):
    cfg = _attn_cfg(**kw)
    jp = j_attn.attn_init(jax.random.key(0), cfg, jnp.float32)
    return cfg, jp, _to_torch(jp)


ATTN_VARIANTS = [dict(), dict(qkv_bias=True, rope_theta=1e6),
                 dict(qk_norm=True, sliding_window=24),
                 dict(rope_fraction=0.25, n_kv_heads=4),
                 dict(n_kv_heads=1, sliding_window=5)]


@pytest.mark.parametrize("impl", ["ref", "chunked", "flash"])
@pytest.mark.parametrize("variant", range(len(ATTN_VARIANTS)))
def test_attention_full_matches_the_reference(variant, impl):
    cfg, jp, tp = _attn_pair(**ATTN_VARIANTS[variant], attn_impl=impl)
    x = np.random.default_rng(3).standard_normal((2, 80, 64))
    pos = np.arange(80)
    want = jax.jit(j_attn.attention_full, static_argnums=0)(
        cfg, jp, jnp.asarray(x, jnp.float32), jnp.asarray(pos))
    got = attn.attention_full(cfg, tp, torch.as_tensor(x, dtype=torch.float32),
                              torch.as_tensor(pos))
    _close(got, want, MODEL)


def test_attention_decode_through_a_wrapping_ring_matches_the_reference():
    """A ring of W = 8 slots under a window of 8, 20 steps: the slots wrap
    twice; each step's output and the cache equal the reference's."""
    cfg, jp, tp = _attn_pair(sliding_window=8, qkv_bias=True)
    x = np.random.default_rng(4).standard_normal((2, 20, 64)).astype(
        np.float32)
    jc = jax.tree.map(lambda a: a[0],
                      j_attn.make_kv_cache(cfg, 2, 8, 1, jnp.float32))
    tc = jax.tree.map(lambda a: a[0], attn.make_kv_cache(
        cfg, 2, 8, 1, torch.float32))
    for t in range(20):
        jy, jc = j_attn.attention_decode(cfg, jp, jnp.asarray(x[:, t:t + 1]),
                                         jc, jnp.asarray(t, jnp.int32))
        ty, tc = attn.attention_decode(cfg, tp, torch.as_tensor(x[:, t:t + 1]),
                                       tc, t)
        _close(ty, jy, MODEL)
    for name in ("k", "v"):
        _close(tc[name], jc[name], MODEL)
    np.testing.assert_array_equal(tc["kpos"].numpy(), np.asarray(jc["kpos"]))


def test_scatter_ring_matches_the_reference():
    jm = JModel(j_get_config("qwen2-7b", reduced=True))
    tm = Model(get_config("qwen2-7b", reduced=True), device="cpu")
    # every layout: zero-padded (S < W), identity (S == W, S == 2W) and
    # rolled (S > W, not a multiple)
    for S, W in ((1, 4), (5, 8), (30, 40), (8, 8), (16, 8), (13, 8),
                 (17, 16), (30, 4)):
        full = np.random.default_rng(S).standard_normal((2, 1, S, 3, 4))
        jb, jk = jm._scatter_ring(jnp.asarray(full, jnp.float32), W)
        tb, tk = tm._scatter_ring(torch.as_tensor(full, dtype=torch.float32),
                                  W)
        np.testing.assert_array_equal(_np(tb), _np(jb))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


# ---------------------------------------------------------------------------
# whole models: the ten archs, reduced
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_the_reference(arch):
    """Logits, and the MoE aux loss (0 without experts)."""
    model, params, ref = _pair(arch)
    logits, aux = model.forward(params, _t(ref["toks"]), _t(ref["pe"]))
    assert logits.dtype == torch.float32 and aux.dtype == torch.float32
    assert logits.shape == (B, ref["P"] + K, model.cfg.vocab_size)
    _close(logits, ref["logits"], MODEL)
    if model.cfg.n_experts:
        assert float(aux) > 0.0
        _close(aux, ref["aux"], MODEL)
    else:
        assert float(aux) == 0.0 == float(ref["aux"])


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference_plain_and_chunked(arch):
    model, params, ref = _pair(arch)
    batch = _batch(ref)
    _close(model.loss(params, batch), ref["loss"], MODEL)
    chunked = Model(dataclasses.replace(model.cfg, loss_chunk=CHUNK),
                    device="cpu")
    _close(chunked.loss(params, batch), ref["loss_chunk"], MODEL)
    _close(chunked.loss(params, batch), model.loss(params, batch), F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_generate_match_the_reference(arch):
    model, params, ref = _pair(arch)
    P, pe = ref["P"], _t(ref["pe"])
    toks = _t(ref["toks"])
    logits, cache = model.prefill(params, toks[:, :K - 1], pe,
                                  max_len=P + K + 4)
    _close(logits, ref["prefill"], MODEL)
    dec, _ = model.decode(params, cache, toks[:, K - 1], P + K - 1)
    _close(dec, ref["decode"], MODEL)
    gen = model.generate(params, toks[:, :16], N_NEW, pe)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(ref["generate"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_forward_equals_the_ref_forward(arch):
    """attn_impl='flash' (the kernel's plain version on the CPU) gives
    the 'ref' forward's logits, as in the reference (1e-4)."""
    model, params, ref = _pair(arch)
    flash = Model(dataclasses.replace(model.cfg, attn_impl="flash"),
                  device="cpu")
    got, _ = flash.forward(params, _t(ref["toks"]), _t(ref["pe"]))
    want, _ = model.forward(params, _t(ref["toks"]), _t(ref["pe"]))
    _close(got, want, MODEL)


def test_bf16_qwen2_7b_matches_the_reference():
    model, params, ref = _pair("qwen2-7b", "bfloat16")
    assert params["embed"].dtype == torch.bfloat16
    toks = _t(ref["toks"])
    logits, _ = model.forward(params, toks)
    _close(logits, ref["logits"], dict(rtol=2e-2, atol=6e-2))
    assert np.abs(_np(logits) - _np(ref["logits"])).mean() < 1e-2
    _close(model.loss(params, _batch(ref)), ref["loss"], dict(rtol=2e-3,
                                                              atol=2e-3))
    gen = model.generate(params, toks[:, :16], N_NEW)
    np.testing.assert_array_equal(gen.numpy(), np.asarray(ref["generate"]))


# ---------------------------------------------------------------------------
# port twins of the reference's pins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    model, params, ref = _pair(arch)
    P, pe, toks = ref["P"], _t(ref["pe"]), _t(ref["toks"])
    full, _ = model.forward(params, toks, pe)
    pre, cache = model.prefill(params, toks[:, :K - 1], pe, max_len=P + K + 4)
    _close(pre, full[:, P + K - 2], PIN)
    dec, _ = model.decode(params, cache, toks[:, K - 1],
                          torch.tensor(P + K - 1))
    _close(dec, full[:, P + K - 1], PIN)


def test_ring_cache_decode_matches_window_forward():
    cfg, _, tp = _attn_pair(sliding_window=4)
    x = torch.as_tensor(np.random.default_rng(5).standard_normal((1, 20, 64)),
                        dtype=torch.float32)
    y_full = attn.attention_full(cfg, tp, x, torch.arange(20))
    cache = {k: v[0] for k, v in attn.make_kv_cache(
        cfg, 1, 4, 1, torch.float32).items()}
    ys = []
    for t in range(20):
        y, cache = attn.attention_decode(cfg, tp, x[:, t:t + 1], cache, t)
        ys.append(y)
    _close(torch.cat(ys, dim=1), y_full, MODEL)


def test_sliding_window_masks_old_positions():
    for impl in ("ref", "chunked", "flash"):
        cfg, _, tp = _attn_pair(sliding_window=4, attn_impl=impl,
                                attn_chunk=5)
        rng = np.random.default_rng(6)
        x1 = rng.standard_normal((1, 12, 64)).astype(np.float32)
        x2 = x1.copy()
        x2[:, 0:3] = rng.standard_normal((1, 3, 64))
        pos = torch.arange(12)
        y1 = attn.attention_full(cfg, tp, torch.as_tensor(x1), pos)
        y2 = attn.attention_full(cfg, tp, torch.as_tensor(x2), pos)
        _close(y1[:, 7:], y2[:, 7:], F32)
        assert float((y1[:, 3] - y2[:, 3]).abs().max()) > 1e-6


def test_gqa_reduces_to_mha_when_kv_equal():
    """With one kv head per q head the grouped path is plain MHA: the
    output equals attention computed head by head."""
    cfg, _, tp = _attn_pair(n_kv_heads=4)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal((2, 8, 64)),
                        dtype=torch.float32)
    pos = torch.arange(8)
    y = attn.attention_full(cfg, tp, x, pos)
    assert y.shape == (2, 8, 64) and bool(torch.isfinite(y).all())
    q, k, v = attn._project_qkv(cfg, tp, x, pos)
    heads = []
    for h in range(4):
        s = (q[:, :, h] @ k[:, :, h].transpose(1, 2)) * 32 ** -0.5
        s = s + attn._causal_mask(8, None, x.device)
        heads.append(torch.softmax(s, -1) @ v[:, :, h])
    _close(y, torch.stack(heads, 2).reshape(2, 8, -1) @ tp["o"]["w"], F32)


def test_rope_preserves_norm_and_relative_property():
    cos, sin = layers.rope_angles(torch.arange(16), 32)
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (1, 16, 2, 32)), dtype=torch.float32)
    xr = layers.apply_rope(x, cos, sin)
    _close(xr.norm(dim=-1), x.norm(dim=-1), dict(rtol=1e-5, atol=0))
    q = layers.apply_rope(torch.ones(1, 16, 1, 32), cos, sin)[0, :, 0]
    d1, d2 = float(q[5] @ q[3]), float(q[9] @ q[7])
    assert d1 == pytest.approx(d2, rel=1e-5)
    xp = layers.apply_rope(x, *layers.rope_angles(torch.arange(16), 8), 0.25)
    assert torch.equal(xp[..., 8:], x[..., 8:])


@pytest.mark.parametrize("arch", ARCHS)
def test_param_count_analytic_close_to_actual(arch):
    cfg = get_config(arch, reduced=True)
    model = Model(cfg, device="cpu")
    actual = model.param_count(model.init(torch.Generator().manual_seed(0)))
    assert abs(actual - cfg.param_count()) / actual < 0.02


# ---------------------------------------------------------------------------
# dispatch, policy, CLI
# ---------------------------------------------------------------------------

def test_model_runs_on_cuda_unless_told_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(get_config("qwen2-7b", reduced=True))
    assert Model(get_config("qwen2-7b", reduced=True),
                 device="cpu").device == torch.device("cpu")


@pytest.mark.parametrize("device,strict", [("cuda", True), ("cpu", False)])
def test_cuda_model_sets_the_precision_policy(monkeypatch, device, strict):
    # building a CUDA model touches no card, only the process-wide flags
    flags = [(torch.backends.cuda.matmul, "allow_tf32"),
             (torch.backends.cuda.matmul,
              "allow_bf16_reduced_precision_reduction")]
    for mod, name in flags:
        monkeypatch.setattr(mod, name, True)
    Model(get_config("qwen2-7b"), device=device)
    for mod, name in flags:
        assert getattr(mod, name) == (not strict), name


@pytest.mark.parametrize("arch", ["qwen2-7b", "internvl2-1b",
                                  "phi3.5-moe-42b-a6.6b", "deepseek-v2-236b",
                                  "mamba2-1.3b", "zamba2-2.7b"])
def test_serve_cli_runs_on_the_cpu(arch, capsys):
    assert serve.main(["--device", "cpu", "--arch", arch, "--batch", "2",
                       "--prompt-len", "8", "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert "prefill: 2x8 tokens" in out and "decode:  2 steps x 2 seqs" in out
    assert out.count("seq") >= 2


def test_serve_cli_refuses_what_it_cannot_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        serve.main(["--arch", "qwen2-7b"])


def test_flash_path_counts_no_launch_on_the_cpu():
    model, params, ref = _pair("qwen2-7b")
    flash = Model(dataclasses.replace(model.cfg, attn_impl="flash"),
                  device="cpu")
    before = fa.flash_attention_cuda.launches
    flash.forward(params, _t(ref["toks"]))
    assert fa.flash_attention_cuda.launches == before
