"""The port's flash attention against the JAX package's.

The same inputs, drawn from a numpy seed, go through the reference's
``ops.flash_attention`` (the Pallas kernel in interpret mode) and
``ref.attention_ref`` and through the port's ``ops.flash_attention`` (on
the CPU: the kernel's plain version, ``ref.flash_attention_ref``),
``ref.flash_attention_ref`` and ``ref.attention_ref``.  Tolerances are
the reference's own (``tests/test_kernels.py``): 2e-5 in fp32 and 2e-2
in bf16.  The CUDA kernel itself runs only on a card
(``tests/test_torch_cuda.py``, marker ``cuda``).

The gradient: the backward kernels' plain version
(``ref.flash_attention_bwd_ref``, which rebuilds the weights from the
saved log-sum-exp as the kernels do) against autograd of the port's
plain chunked attention and ``jax.grad`` of the reference's, in fp32
(``GRAD_TOL``: the same sums in other orders); and the entry point's
gradient under ``vmap(grad)`` and inside ``remat`` (its ``vmap`` rule
folds the clients into the batch) against the same.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas as j_pallas
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attention
from repro.configs import get_config as j_get_config
from repro.models import attention as j_attn
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import attention as attn
from repro_torch.models.remat import remat

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
GRAD_TOL = dict(rtol=2e-5, atol=2e-5)
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(seed, B, S, Hq, Hkv, hd, dtype, layout="bshd"):
    """numpy draws -> (jax arrays, torch tensors) holding the same values
    (bf16 rounded once, in numpy)."""
    rng = np.random.default_rng(seed)
    shapes = [(B, S, Hq, hd), (B, S, Hkv, hd), (B, S, Hkv, hd)]
    if layout == "bhsd":
        shapes = [(s[0], s[2], s[1], s[3]) for s in shapes]
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16).astype(np.float32) for a in arrs]
    js = [jnp.asarray(a, JNP[dtype]) for a in arrs]
    ts = [torch.as_tensor(a).to(TORCH[dtype]) for a in arrs]
    return js, ts


def _close(got, want, dtype):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got, np.float32)
    want = want.float().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def _both_ways(js, ts, dtype, **kw):
    """The port's entry point and oracle against the reference's kernel
    and oracle (all four pairs that matter)."""
    want_kernel = j_flash(*js, bq=64, bk=64, **kw)
    want_oracle = j_attention(*js, **kw)
    got = ops.flash_attention(*ts, **kw)
    assert got.dtype == ts[0].dtype and got.shape == ts[0].shape
    _close(got, want_kernel, dtype)
    _close(got, want_oracle, dtype)
    _close(ref.attention_ref(*ts, **kw), want_oracle, dtype)
    bhsd = [t.transpose(1, 2).contiguous() for t in ts]
    plain = ref.flash_attention_ref(*bhsd, **kw).transpose(1, 2)
    torch.testing.assert_close(plain, got, rtol=0, atol=0)


# the reference's shapes (test_kernels.py:75-78: ragged S 130 and 200,
# GQA groups 1-4 and 8) plus hd 128 with a ragged S and group 3, and
# zamba2's head dim 80
SHAPES = [(1, 128, 4, 4, 64), (2, 256, 4, 2, 32), (1, 130, 8, 1, 64),
          (1, 64, 2, 2, 128), (2, 200, 6, 3, 32), (1, 130, 6, 2, 128),
          (1, 130, 4, 4, 80)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_matches_reference_causal(shape, dtype):
    js, ts = _qkv(sum(shape), *shape, dtype)
    _both_ways(js, ts, dtype, causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [16, 64, 100])
def test_flash_matches_reference_sliding_window(window, dtype):
    js, ts = _qkv(7, 1, 192, 4, 2, 64, dtype)
    _both_ways(js, ts, dtype, causal=True, window=window)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_matches_reference_noncausal(dtype):
    js, ts = _qkv(8, 2, 128, 2, 2, 32, dtype)
    _both_ways(js, ts, dtype, causal=False)


@pytest.mark.parametrize("causal,window,seq_k", [
    (True, None, 100), (False, None, 70), (True, 32, 90),
    (False, None, 0)])                     # 0 keys: every row dead -> 0
def test_kernel_plain_version_matches_pallas_kv_tail(causal, window, seq_k):
    """The kernel's own layout and tail mask: ``flash_attention_ref``
    against ``flash_attention_pallas`` on (B, H, S, hd) inputs with
    ``true_seq_k`` (dead rows come out 0 in both)."""
    js, ts = _qkv(9, 1, 128, 4, 2, 32, "float32", layout="bhsd")
    want = j_pallas(*js, causal=causal, window=window, true_seq_k=seq_k,
                    bq=64, bk=64, interpret=True)
    got = ref.flash_attention_ref(*ts, causal=causal, window=window,
                                  true_seq_k=seq_k)
    _close(got, want, "float32")
    if seq_k == 0:
        assert not got.any()


def test_head_dims_run_at_the_next_instantiated_one():
    assert fa.HEAD_DIMS == (32, 64, 128)
    assert [fa.padded_head_dim(h) for h in (8, 32, 48, 64, 80, 96, 128)] \
        == [32, 32, 64, 64, 128, 128, 128]
    with pytest.raises(ValueError, match="up to 128"):
        fa.padded_head_dim(160)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd,window", [(80, None), (80, 40), (48, None)])
def test_zero_padded_head_dim_gives_the_unpadded_function(hd, window, dtype):
    """What ``flash_attention_cuda`` launches at a head dim it pads: the
    kernel's plain version on the zero-padded operands, with q scaled by
    ``(hd_pad / hd) ** 0.5`` so that its ``hd_pad ** -0.5`` gives the
    true ``hd ** -0.5``, its first hd columns, equals the plain version
    on the unpadded ones (2e-5 fp32, 2e-2 bf16) and the reference's
    Pallas kernel; the padded operands are views of (B, S, H, hd_pad)
    buffers, the model's layout."""
    js, ts = _qkv(hd + (window or 0), 2, 128, 4, 2, hd, dtype,
                  layout="bhsd")
    hp = fa.padded_head_dim(hd)
    padded = [fa.pad_head_dim(t, hp) for t in ts]
    for t, p in zip(ts, padded):
        assert p.shape[3] == hp and p.transpose(1, 2).is_contiguous()
        assert torch.equal(p[..., :hd], t) and not p[..., hd:].any()
    pq, pk, pv = padded
    got = ref.flash_attention_ref(pq * (hp / hd) ** 0.5, pk, pv,
                                  window=window)[..., :hd]
    _close(got, ref.flash_attention_ref(*ts, window=window), dtype)
    _close(got, j_pallas(*js, window=window, bq=64, bk=64, interpret=True),
           dtype)


def test_entry_point_runs_the_plain_version_on_the_cpu():
    _, ts = _qkv(10, 1, 70, 4, 2, 32, "float32")
    before = fa.flash_attention_cuda.launches
    got = ops.flash_attention(*ts, causal=True, window=20)
    assert fa.flash_attention_cuda.launches == before
    bhsd = [t.transpose(1, 2).contiguous() for t in ts]
    want = ref.flash_attention_ref(*bhsd, causal=True, window=20)
    torch.testing.assert_close(got, want.transpose(1, 2), rtol=0, atol=0)


def test_cuda_wrapper_raises_on_cpu_tensors():
    _, ts = _qkv(11, 1, 64, 2, 1, 32, "float32", layout="bhsd")
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa.flash_attention_cuda(*ts)


@pytest.mark.parametrize("kw,shapes", [
    (dict(window=0), None),
    (dict(window=-3), None),
    ({}, [(1, 4, 8, 32), (1, 3, 8, 32), (1, 3, 8, 32)]),    # Hq % Hkv
    ({}, [(1, 4, 8, 32), (1, 2, 8, 16), (1, 2, 8, 16)]),    # head dims
    ({}, [(1, 4, 8, 32), (1, 2, 8, 32), (1, 2, 9, 32)]),    # k vs v
])
def test_invalid_arguments_raise_on_any_device(kw, shapes):
    shapes = shapes or [(1, 4, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32)]
    q, k, v = (torch.zeros(s) for s in shapes)
    with pytest.raises(ValueError):
        fa.check_shapes(q, k, v, kw.get("window"), None)
    with pytest.raises(ValueError):
        ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), **kw)


# (B, S, Hq, Hkv, hd, window): a ragged S, GQA groups 1 / 2 / 3 / 4,
# windows, head dims 32 / 64 / 128 and zamba2's 80
GRAD_CASES = [(2, 37, 4, 2, 32, None), (1, 64, 4, 4, 64, 16),
              (1, 50, 6, 2, 80, None), (1, 29, 8, 2, 128, 7),
              (2, 45, 3, 1, 64, 20)]


def _grad_inputs(seed, B, S, Hq, Hkv, hd):
    """fp32 q, k, v (B, S, H, hd) and an output cotangent, from numpy."""
    _, (q, k, v) = _qkv(seed, B, S, Hq, Hkv, hd, "float32")
    g = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (B, S, Hq, hd)).astype(np.float32))
    return q, k, v, g


def _chunk_cfgs():
    """(port, reference) configs whose ``_chunked_sdpa`` walks 8-row
    query chunks, without remat."""
    kw = dict(attn_chunk=8, remat=False)
    return (dataclasses.replace(get_config("stablelm-1.6b", reduced=True),
                                **kw),
            dataclasses.replace(j_get_config("stablelm-1.6b", reduced=True),
                                **kw))


def _plain_grads(q, k, v, g, window):
    """Autograd of the port's plain chunked attention (the CPU route)."""
    cfg, _ = _chunk_cfgs()
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = attn._chunked_sdpa(*qkv, window, cfg)
    out.backward(g.reshape(out.shape))
    return [t.grad for t in qkv]


def _bwd_ref_grads(q, k, v, g, window):
    """(dq, dk, dv) of ``flash_attention_bwd_ref`` on the model layout,
    from the plain forward's output and LSE."""
    bhsd = [t.transpose(1, 2) for t in (q, k, v, g)]
    o, lse = ref.flash_attention_ref(*bhsd[:3], window=window,
                                     with_lse=True)
    return [t.transpose(1, 2) for t in ref.flash_attention_bwd_ref(
        *bhsd[:3], o, lse, bhsd[3], window=window)]


@pytest.mark.parametrize("B,S,Hq,Hkv,hd,window", GRAD_CASES)
def test_backward_plain_version_matches_the_chunked_gradient(
        B, S, Hq, Hkv, hd, window):
    q, k, v, g = _grad_inputs(20 + hd, B, S, Hq, Hkv, hd)
    for a, b in zip(_bwd_ref_grads(q, k, v, g, window),
                    _plain_grads(q, k, v, g, window)):
        torch.testing.assert_close(a, b, **GRAD_TOL)


def test_backward_plain_version_matches_the_reference_jax_grad():
    """One shape with every feature at once (a ragged S, GQA group 3, a
    window, zamba2's head dim 80): ``jax.grad`` of the reference's
    ``_chunked_sdpa`` compiles once a shape."""
    B, S, Hq, Hkv, hd, window = 2, 45, 6, 2, 80, 20
    q, k, v, g = _grad_inputs(20 + hd, B, S, Hq, Hkv, hd)
    got = _bwd_ref_grads(q, k, v, g, window)
    _, jcfg = _chunk_cfgs()
    js = [jnp.asarray(t.numpy()) for t in (q, k, v)]
    gj = jnp.asarray(g.numpy()).reshape(B, S, Hq * hd)
    want = jax.grad(lambda *a: jnp.sum(
        j_attn._chunked_sdpa(*a, window, jcfg) * gj), argnums=(0, 1, 2))(
        *js)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   **GRAD_TOL)


def test_lse_is_the_rows_log_sum_exp():
    """The saved log-sum-exp: logsumexp of the visible scaled scores, -inf
    for a row that sees no key (masked kv tail)."""
    _, ts = _qkv(21, 1, 40, 2, 1, 32, "float32", layout="bhsd")
    q, k, v = ts
    _, lse = ref.flash_attention_ref(q, k, v, window=5, true_seq_k=30,
                                     with_lse=True)
    s = (q @ k.transpose(-1, -2)) * 32 ** -0.5
    i, j = torch.arange(40)[:, None], torch.arange(40)[None, :]
    ok = (j <= i) & (i - j < 5) & (j < 30)
    want = torch.logsumexp(torch.where(ok, s, -torch.inf), -1)
    assert torch.isneginf(lse[..., 34:]).all()
    torch.testing.assert_close(lse, want, rtol=1e-6, atol=1e-6)


def test_backward_gives_the_plain_chunked_gradient():
    """``ops.flash_attention`` differentiates (on the CPU through the
    backward kernels' plain version) to the plain path's gradient."""
    q, k, v, g = _grad_inputs(12, 1, 16, 2, 1, 32)
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*qkv)
    assert out.requires_grad
    out.backward(g)
    for t, want in zip(qkv, _plain_grads(q, k, v, g, None)):
        torch.testing.assert_close(t.grad, want, **GRAD_TOL)


@pytest.mark.parametrize("in_remat", [False, True])
@pytest.mark.parametrize("batched", ["all", "q only"])
def test_gradient_under_vmap_of_grad(in_remat, batched):
    """The federated training path: ``vmap`` over 3 clients of ``grad``,
    with the call inside ``remat`` (whose backward runs ``torch.func.vjp``
    under its generated ``vmap`` rule) or not, k / v per client or shared.
    Each client's gradient is the plain path's for its slice."""
    N, B, S, Hq, Hkv, hd, window = 3, 2, 21, 4, 2, 32, 9
    qs, ks, vs, gs = zip(*(_grad_inputs(30 + i, B, S, Hq, Hkv, hd)
                           for i in range(N)))
    q, k, v = torch.stack(qs), torch.stack(ks), torch.stack(vs)
    if batched == "q only":
        k, v = k[0], v[0]
    in_dims = (0, 0, 0) if batched == "all" else (0, None, None)
    g = gs[0]

    def attend(q, k, v):
        if in_remat:
            out, = remat(lambda _, *a: (ops.flash_attention(
                *a, window=window),), (), q, k, v)
            return out
        return ops.flash_attention(q, k, v, window=window)

    got = torch.func.vmap(torch.func.grad(
        lambda *a: (attend(*a) * g).sum(), argnums=(0, 1, 2)),
        in_dims=in_dims)(q, k, v)
    for i in range(N):
        ki, vi = (k[i], v[i]) if batched == "all" else (k, v)
        want = _plain_grads(q[i], ki, vi, g, window)
        for a, b in zip(got, want):
            torch.testing.assert_close(a[i], b, **GRAD_TOL)


def test_plain_versions_differ_at_bf16_only_by_the_weights_rounding():
    """``attention_ref`` rounds the softmax weights to bf16 before the PV
    product, the kernel's plain version keeps them fp32: at fp32 the two
    agree to rounding, at bf16 within the reference's bf16 tolerance."""
    for dtype in ("float32", "bfloat16"):
        _, ts = _qkv(13, 2, 96, 4, 2, 64, dtype)
        bhsd = [t.transpose(1, 2).contiguous() for t in ts]
        got = ref.flash_attention_ref(*bhsd).transpose(1, 2)
        _close(got, ref.attention_ref(*ts), dtype)


def _strided(t, pad):
    """The same values as ``t`` (B, S, H, hd) in a view whose last axis is
    contiguous but whose other strides are not t's: each hd-row sits in a
    buffer ``pad`` elements wider."""
    B, S, H, hd = t.shape
    buf = torch.zeros(B, S, H, hd + pad, dtype=t.dtype)
    buf[..., :hd] = t
    return buf[..., :hd]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strided_views_give_what_contiguous_inputs_give(dtype):
    """The kernels take (B, H, S, hd) views by their strides: the model's
    (B, S, H, hd) tensors transposed, or rows inside a wider buffer.  The
    plain version and the entry point give on such views exactly what they
    give on contiguous copies."""
    _, ts = _qkv(14, 2, 70, 4, 2, 32, dtype)
    views = [_strided(t, 8) for t in ts]           # 80 elements a row
    assert not views[0].is_contiguous()
    kw = dict(causal=True, window=24)
    got = ops.flash_attention(*views, **kw)
    want = ops.flash_attention(*ts, **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    bhsd = [t.transpose(1, 2) for t in views]     # strided (B, H, S, hd)
    plain = ref.flash_attention_ref(*bhsd, **kw)
    copies = [t.contiguous() for t in bhsd]
    torch.testing.assert_close(plain, ref.flash_attention_ref(*copies, **kw),
                               rtol=0, atol=0)
    torch.testing.assert_close(got, plain.transpose(1, 2), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_entry_point_returns_the_model_layout_contiguous(dtype):
    """``ops.flash_attention`` returns a (B, S, H, hd)-contiguous tensor,
    so the model's reshape to (B, S, H * hd) copies nothing."""
    _, ts = _qkv(15, 2, 40, 4, 2, 64, dtype)
    out = ops.flash_attention(*ts)
    assert out.shape == ts[0].shape and out.is_contiguous()


def _misaligned(kind):
    q = torch.zeros(1, 4, 8, 32)                  # (B, H, S, hd)
    if kind == "last axis strided":
        return q.transpose(2, 3).contiguous().transpose(2, 3)
    if kind == "base":                            # 4 bytes past 16
        return torch.zeros(1 + 4 * 8 * 32).narrow(0, 1, 4 * 8 * 32) \
            .view(1, 4, 8, 32)
    if kind == "row stride":                      # 33 floats = 132 bytes
        return torch.zeros(1, 4, 8, 33)[..., :32]
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["last axis strided", "base",
                                  "row stride"])
def test_misaligned_views_raise_on_any_device(kind):
    """The stride and alignment rules (TMA's) are checked in
    ``check_shapes``, so a CPU tensor that the kernel could not take
    raises as a CUDA one would."""
    q = _misaligned(kind)
    k = v = torch.zeros(1, 2, 8, 32)
    with pytest.raises(ValueError, match="contiguous|aligned"):
        fa.check_shapes(q, k, v, None, None)
    with pytest.raises(ValueError, match="contiguous|aligned"):
        fa.check_shapes(k[:, :1].expand(1, 4, 8, 32).contiguous(), q[:, :2],
                        v, None, None)
    with pytest.raises(ValueError, match="contiguous|aligned"):
        ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2))
