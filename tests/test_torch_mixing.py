"""Graph-mixing kernels of the PyTorch port against the JAX reference.

The same numpy inputs (made from a seed) go through ``repro``'s Pallas
kernels and ops -- in interpret mode on the CPU, as the reference's own
tests run them -- and through ``repro_torch``'s, whose kernel wrappers
take their plain PyTorch versions for CPU tensors.  Then the port's own
bitwise pins: all-ones ``active`` == ``None``, ``weights=1.0`` == ``None``,
``m == 0`` gives the zero row.

Tolerances: fp32 outputs ``rtol=1e-5, atol=1e-6`` -- XLA and torch sum
the n products in different orders, a few fp32 ulps apart.  bf16 mixed
outputs ``rtol=atol=1e-2``: both sides accumulate in fp32 and round once
to bf16, and a few-ulp fp32 difference can flip that rounding by one bf16
ulp (2^-8 relative).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mixing import fused as jfused
from repro.kernels.mixing import mixing as jmixing
from repro.kernels.mixing import ops as jops
from repro_torch.kernels.mixing import fused, mixing, ops, ref

jax.config.update("jax_enable_x64", False)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
BF16_TOL = dict(rtol=1e-2, atol=1e-2)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(n, p, seed, eye=False):
    rng = np.random.default_rng(seed)
    A = np.eye(n, dtype=np.float32) if eye else \
        rng.random((n, n)).astype(np.float32)
    if not eye:
        A /= A.sum(axis=0, keepdims=True)         # column-stochastic
    X = rng.standard_normal((n, p)).astype(np.float32)
    tau = rng.integers(0, 2, n).astype(np.float32)
    tau[0] = 1.0
    active = np.ones(n, np.float32)
    active[rng.permutation(n)[: max(1, n // 3)]] = 0.0
    return A, X, tau, active


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


# ---------------------------------------------------------------------------
# kernel modules: Pallas (interpret) vs the port's wrappers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_kernel_modules_match_pallas(dt):
    jdt, tdt = DTYPES[dt]
    n, p, chunk = 8, 256, 128            # Pallas-aligned shapes
    A, X, tau, _ = _inputs(n, p, seed=1)
    w = (tau @ A) / tau.sum()
    w_pad = np.zeros((8, n), np.float32)
    w_pad[0] = w
    tol = F32_TOL if dt == "f32" else BF16_TOL

    want = jmixing.mix_pallas(_j(A), _j(X, jdt), chunk=chunk, interpret=True)
    _close(mixing.mix_cuda(_t(A), _t(X, tdt)), want, tol)

    want = jfused.aggregate_pallas(_j(w_pad), _j(X, jdt), chunk=chunk,
                                   interpret=True)[0]
    _close(fused.aggregate_cuda(_t(w), _t(X, tdt)), want, F32_TOL)

    wm, wa = jfused.mix_aggregate_pallas(_j(A), _j(w_pad), _j(X, jdt),
                                         chunk=chunk, interpret=True)
    gm, ga = fused.mix_aggregate_cuda(_t(A), _t(w), _t(X, tdt))
    assert gm.dtype == tdt and ga.dtype == torch.float32
    _close(gm, wm, tol)
    _close(ga, wa[0], F32_TOL)


# ---------------------------------------------------------------------------
# ops: ragged n / p, A = I, active, weights, m = 0, both dtypes
# ---------------------------------------------------------------------------

CASES = {
    "ragged": dict(n=5, p=300),
    "aligned": dict(n=8, p=256),
    "eye": dict(n=6, p=130, eye=True),
    "active": dict(n=7, p=200, active=True),
    "weights": dict(n=6, p=150, weights=0.5),
    "m0": dict(n=5, p=140, m0=True),
}


def _case(name, seed):
    c = CASES[name]
    A, X, tau, active = _inputs(c["n"], c["p"], seed, eye=c.get("eye"))
    act = active if c.get("active") else None
    m = 0.0 if c.get("m0") else float((tau * (act if act is not None
                                              else 1.0)).sum())
    return A, X, tau, m, act, c.get("weights")


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ops_match_reference(case, dt):
    jdt, tdt = DTYPES[dt]
    A, X, tau, m, act, weights = _case(case, seed=2)
    tol = F32_TOL if dt == "f32" else BF16_TOL
    jkw = dict(chunk=256, active=None if act is None else _j(act),
               weights=weights)
    tkw = dict(active=None if act is None else _t(act), weights=weights)

    want_w = jops.combine_weights(_j(A), _j(tau), jnp.float32(m),
                                  jkw["active"], weights)
    got_w = ops.combine_weights(_t(A), _t(tau), m, tkw["active"], weights)
    _close(got_w, want_w, F32_TOL)

    wm, wa = jops.mix_aggregate(_j(A), _j(tau), jnp.float32(m),
                                _j(X, jdt), **jkw)
    gm, ga = ops.mix_aggregate(_t(A), _t(tau), m, _t(X, tdt), **tkw)
    _close(gm, wm, tol)
    _close(ga, wa, F32_TOL)

    want = jops.aggregate(_j(A), _j(tau), jnp.float32(m), _j(X, jdt), **jkw)
    _close(ops.aggregate(_t(A), _t(tau), m, _t(X, tdt), **tkw), want,
           F32_TOL)

    want = jops.mix(_j(A), _j(X, jdt), chunk=256)
    _close(ops.mix(_t(A), _t(X, tdt)), want, tol)
    if case == "m0":
        assert not ga.any()


def test_grouped_and_pytree_match_reference():
    n = 6
    A, X, tau, _ = _inputs(n, 200, seed=3)
    m = float(tau.sum())
    Xb = np.random.default_rng(4).standard_normal((n, 90)).astype(np.float32)
    jbufs = (_j(X), _j(Xb, jnp.bfloat16))
    tbufs = (_t(X), _t(Xb, torch.bfloat16))

    wmix, wagg = jops.mix_aggregate_grouped(_j(A), _j(tau), jnp.float32(m),
                                            jbufs, chunk=256)
    gmix, gagg = ops.mix_aggregate_grouped(_t(A), _t(tau), m, tbufs)
    for g, w, tol in zip(gmix, wmix, (F32_TOL, BF16_TOL)):
        _close(g, w, tol)
    for g, w in zip(gagg, wagg):
        _close(g, w, F32_TOL)
    want = jops.aggregate_grouped(_j(A), _j(tau), jnp.float32(m), jbufs,
                                  chunk=256)
    for g, w in zip(ops.aggregate_grouped(_t(A), _t(tau), m, tbufs), want):
        _close(g, w, F32_TOL)

    tree = {"b": X[:, :20].reshape(n, 4, 5), "a": Xb[:, :7]}
    want = jops.mix_pytree(_j(A), {"b": _j(tree["b"]), "a": _j(tree["a"])},
                           chunk=256)
    got = ops.mix_pytree(_t(A), {"b": _t(tree["b"]), "a": _t(tree["a"])})
    for k in tree:
        assert tuple(got[k].shape) == tree[k].shape
        _close(got[k], want[k], F32_TOL)


# ---------------------------------------------------------------------------
# the port's bitwise pins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_all_ones_active_and_unit_weights_are_bitwise_none(dt):
    _, tdt = DTYPES[dt]
    A, X, tau, _ = _inputs(7, 333, seed=5)
    A, X, tau = _t(A), _t(X, tdt), _t(tau)
    m = float(tau.sum())
    ones = torch.ones(7)
    base_w = ops.combine_weights(A, tau, m)
    assert torch.equal(ops.combine_weights(A, tau, m, active=ones), base_w)
    assert torch.equal(ops.combine_weights(A, tau, m, weights=1.0), base_w)
    bm, ba = ops.mix_aggregate(A, tau, m, X)
    for kw in (dict(active=ones), dict(weights=1.0),
               dict(active=ones, weights=1.0)):
        gm, ga = ops.mix_aggregate(A, tau, m, X, **kw)
        assert torch.equal(gm, bm) and torch.equal(ga, ba)
        assert torch.equal(ops.aggregate(A, tau, m, X, **kw),
                           ops.aggregate(A, tau, m, X))


def test_m_zero_gives_zero_row_and_is_inert_otherwise():
    A, X, tau, _ = _inputs(5, 64, seed=6)
    A, X, tau = _t(A), _t(X), _t(tau)
    w0 = ops.combine_weights(A, tau, 0.0)
    assert torch.equal(w0, torch.zeros(5))
    assert torch.equal(ops.aggregate(A, tau, 0.0, X), torch.zeros(64))
    m = float(tau.sum())
    assert torch.equal(ops.combine_weights(A, tau, m), (tau @ A) / m)


def test_wrappers_use_plain_versions_on_cpu():
    A, X, tau, _ = _inputs(4, 50, seed=7)
    A, X = _t(A), _t(X)
    w = torch.rand(4)
    before = (mixing.mix_cuda.launches, fused.aggregate_cuda.launches,
              fused.mix_aggregate_cuda.launches)
    assert torch.equal(mixing.mix_cuda(A, X), ref.mix_ref(A, X))
    assert torch.equal(fused.aggregate_cuda(w, X), ref.aggregate_ref(w, X))
    got = fused.mix_aggregate_cuda(A, w, X)
    want = ref.mix_aggregate_ref(A, w, X)
    assert all(torch.equal(g, h) for g, h in zip(got, want))
    # CPU tensors never count as kernel launches
    assert (mixing.mix_cuda.launches, fused.aggregate_cuda.launches,
            fused.mix_aggregate_cuda.launches) == before
