"""The quantized-payload slice of the PyTorch port against the JAX
reference.

Host-side parts must equal the reference exactly: ``QuantSpec``
validation and its dict form, the packed layout and byte counts of
``pack_spec(quant=)``, and -- for nearest rounding -- the stored
containers, scales, dequantized values and error-feedback residuals of
the quantizer (bitwise, all three storages, zero blocks and .5 ties
included); plans carrying a spec serialize byte-identically.

Mixing: the same numpy inputs go through the reference's dequant Pallas
kernels (``repro.kernels.mixing.ops.*_q``, interpret mode on the CPU)
and the port's ``ops.*_q``, whose wrappers take their plain versions for
CPU tensors: ``rtol=1e-5, atol=1e-6`` (fp32 sums in another order).

Rounds: the port's quantized round function on every quant backend
against the reference's ``make_round_fn(quant=)``.  XLA and torch compute
the client deltas a few fp32 ulps apart, so a value lying within that
distance of a rounding boundary can round to the neighbouring grid point
on one side only.  Residuals are compared ``rtol=1e-5, atol=1e-6`` and
params ``rtol=1e-4, atol=1e-5`` (as in ``test_torch_slice.py``), each
with an allowance at such values: one grid step (the block's scale) for a
residual, the combine-row-weighted steps summed over the rounds for a
param; the test counts them and keeps them rare.  Then the
port's own pins: scanned == sequential bitwise with the error-feedback
carry, stochastic rounding's properties (its generator is the port's own,
see ``repro_torch.fl.packing``), the backend matrix and the CLI.
"""

import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rounds import make_round_fn as jmake_round_fn
from repro.core.sparse import SparseA as JSparseA
from repro.fl import ExecutionConfig as JExec
from repro.fl import make_engine as jmake_engine
from repro.fl import packing as jpacking
from repro.kernels.mixing import ops as jops
from repro.launch import train as jtrain
from repro.models import cnn as jcnn
from repro_torch.core.pytree import tree_flatten
from repro_torch.core.rounds import (QUANT_BACKENDS, client_deltas,
                                     make_round_fn, make_scanned_rounds)
from repro_torch.core.sparse import SparseA
from repro_torch.fl import packing
from repro_torch.fl.engine import ExecutionConfig, make_engine
from repro_torch.fl.packing import QuantSpec
from repro_torch.kernels.mixing import fused, ops, ref, sparse
from repro_torch.launch import train
from repro_torch.models import cnn
from repro_torch.models.convert import params_from_numpy
from test_torch_sparse import _batches, _plans, jquad_loss, quad_loss

jax.config.update("jax_enable_x64", False)

F32_TOL = dict(rtol=1e-5, atol=1e-6)
SPECS = [dict(storage="int8", block=128), dict(storage="int4", block=256),
         dict(storage="fp8", block=128), dict(storage="int8", block=512)]
SPEC_IDS = ["int8-128", "int4-256", "fp8-128", "int8-512"]


def _pair(**kw):
    return QuantSpec(**kw), jpacking.QuantSpec(**kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.float8_e4m3fn:
            return x.view(torch.uint8).numpy()
        return x.float().numpy() if x.is_floating_point() else x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "float8_e4m3fn":
        return x.view(np.uint8)
    return x.astype(np.float32) if x.dtype.kind == "f" else x


def _payload(n, p, block, seed, qmax):
    """Seeded payload with an all-zero block, a block of exact .5 ties on
    its grid (absmax = qmax, so the scale is 1.0) and a mixed scale."""
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((n, p)) * 10.0 ** rng.integers(
        -4, 1, (n, 1))).astype(np.float32)
    X[0, :block] = 0.0
    X[1, :block] = (np.arange(block) % 15 - 7 + 0.5).astype(np.float32)
    X[1, 0] = qmax
    return X


# ---------------------------------------------------------------------------
# QuantSpec and the packed layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(storage="int2"), dict(rounding="banker"),
    dict(storage="fp8", rounding="stochastic"), dict(block=64),
    dict(storage="int4", block=384), dict(block=0)])
def test_quantspec_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        jpacking.QuantSpec(**kw)
    with pytest.raises(ValueError) as got:
        QuantSpec(**kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", SPECS + [
    dict(storage="int4", block=512, rounding="stochastic",
         error_feedback=False, seed=7)])
def test_quantspec_fields_and_dict_match_reference(kw):
    q, jq = _pair(**kw)
    assert q.as_dict() == jq.as_dict()
    assert QuantSpec.from_dict(json.loads(json.dumps(q.as_dict()))) == q
    assert (q.qmax, q.bits, q.stored_cols(1024)) == \
        (jq.qmax, jq.bits, jq.stored_cols(1024))
    assert str(q.storage_dtype).split(".")[-1] == jq.storage_dtype.name


def _trees(model, n=3):
    """A per-client delta tree (leading axis n) in both frameworks: the
    CNN's or logreg's leaves, or a tree with a bf16 group beside fp32."""
    if model == "mixed":
        shapes = {"w": ((384,), "bf16"), "b": ((130,), "f32"),
                  "e": ((7, 70), "f32")}
        jtree = {k: jnp.zeros((n,) + shp, jnp.bfloat16 if dt == "bf16"
                              else jnp.float32)
                 for k, (shp, dt) in shapes.items()}
        ttree = {k: torch.zeros((n,) + shp, dtype=torch.bfloat16
                                if dt == "bf16" else torch.float32)
                 for k, (shp, dt) in shapes.items()}
        return ttree, jtree
    init = {"cnn": jcnn.init_cnn, "logreg": jcnn.init_logreg}[model]
    jtree = jax.tree.map(lambda v: jnp.zeros((n,) + v.shape, v.dtype),
                         init(0))
    return params_from_numpy(jax.tree.map(np.asarray, jtree)), jtree


@pytest.mark.parametrize("model", ["cnn", "logreg", "mixed"])
@pytest.mark.parametrize("kw", SPECS, ids=SPEC_IDS)
def test_pack_spec_layout_and_bytes_match_reference(model, kw):
    q, jq = _pair(**kw)
    ttree, jtree = _trees(model)
    spec = packing.pack_spec(ttree, quant=q)
    jspec = jpacking.pack_spec(jtree, quant=jq)
    assert [g.padded for g in spec.groups] == \
        [g.padded for g in jspec.groups]
    assert [q.stored_cols(g.padded) for g in spec.groups] == \
        [jq.stored_cols(g.padded) for g in jspec.groups]
    for n in (1, 70):
        assert spec.nbytes(n) == jspec.nbytes(n)
        assert spec.scales_nbytes(n) == jspec.scales_nbytes(n)
        assert spec.quantized_nbytes(n) == jspec.quantized_nbytes(n)
    assert packing.pack_spec(ttree, quant=q) is spec          # cached
    assert packing.pack_spec(ttree).quant is None
    with pytest.raises(ValueError, match="no quant config"):
        packing.pack_spec(ttree).quantized_nbytes(1)


# ---------------------------------------------------------------------------
# the quantizer: bitwise the reference's for nearest rounding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", SPECS, ids=SPEC_IDS)
def test_quantize_dequantize_group_bitwise(kw):
    q, jq = _pair(**kw)
    X = _payload(5, 4 * q.block, q.block, seed=q.block, qmax=q.qmax)
    stored, scales = packing.quantize_group(torch.from_numpy(X), q)
    jstored, jscales = jpacking.quantize_group(jnp.asarray(X), jq)
    assert stored.dtype == q.storage_dtype
    assert stored.shape == (5, q.stored_cols(4 * q.block))
    np.testing.assert_array_equal(_np(stored), _np(jstored))
    np.testing.assert_array_equal(_np(scales), _np(jscales))
    assert (scales[0, 0] == 0).all()
    dq = packing.dequantize_group(stored, scales, q)
    np.testing.assert_array_equal(
        _np(dq), _np(jpacking.dequantize_group(jstored, jscales, jq)))
    assert (dq[0, :q.block] == 0).all()
    # the kernels' plain dequant is the same arithmetic
    assert torch.equal(ref.dequant_ref(stored, scales, q.storage, q.block),
                       dq)


@pytest.mark.parametrize("kw", SPECS[:3], ids=SPEC_IDS[:3])
def test_quantize_packed_with_residuals_bitwise(kw):
    q, jq = _pair(**kw)
    rng = np.random.default_rng(3)
    tree = {"w": rng.standard_normal((4, 384)).astype(np.float32),
            "b": rng.standard_normal((4, 130)).astype(np.float32)}
    ttree = {k: torch.from_numpy(v) for k, v in tree.items()}
    jtree = {k: jnp.asarray(v) for k, v in tree.items()}
    spec = packing.pack_spec(ttree, quant=q)
    jspec = jpacking.pack_spec(jtree, quant=jq)
    bufs, jbufs = packing.pack(ttree, spec), jpacking.pack(jtree, jspec)
    res, key = packing.init_quant_state(spec, 4)
    jres, _ = jpacking.init_quant_state(jspec, 4)
    assert key == (0, 0)
    for _ in range(2):             # the second step carries residuals
        stored, scales, res = packing.quantize_packed(bufs, spec, res)
        jstored, jscales, jres = jpacking.quantize_packed(jbufs, jspec, jres)
        for a, b in zip(stored + scales + res, jstored + jscales + jres):
            np.testing.assert_array_equal(_np(a), _np(b))
    dq = packing.dequantize_packed(stored, scales, spec)
    for a, b in zip(dq, jpacking.dequantize_packed(jstored, jscales, jspec)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_nibbles_round_trip():
    v = torch.from_numpy(np.random.default_rng(1).integers(
        -8, 8, (3, 256)).astype(np.int8))
    packed = packing._pack_nibbles(v)
    assert packed.shape == (3, 128)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jpacking._pack_nibbles(
            jnp.asarray(v.numpy()))))
    assert torch.equal(packing._unpack_nibbles(packed), v)


# ---------------------------------------------------------------------------
# stochastic rounding: the port's own generator, held to its properties
# ---------------------------------------------------------------------------

def test_stochastic_rounding_brackets_and_replays():
    q = QuantSpec(storage="int8", block=128, rounding="stochastic")
    X = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 512)).astype(np.float32))
    key = (5, 0)
    s1, sc1 = packing.quantize_group(
        X, q, packing._group_generator(key, 0, X.device))
    s2, sc2 = packing.quantize_group(
        X, q, packing._group_generator(key, 0, X.device))
    assert torch.equal(s1, s2) and torch.equal(sc1, sc2)
    y = (X.reshape(3, 4, 128) / sc1[:, :, None]).reshape(3, 512)
    lo = torch.floor(y)
    assert ((s1.float() == lo) | (s1.float() == lo + 1)).all()
    s3, _ = packing.quantize_group(
        X, q, packing._group_generator((5, 1), 0, X.device))
    assert not torch.equal(s1, s3)       # the counter moves the stream
    with pytest.raises(ValueError, match="generator"):
        packing.quantize_group(X, q)


@pytest.mark.parametrize("storage,block", [("int8", 128), ("int4", 256)])
def test_stochastic_rounding_is_unbiased(storage, block):
    q = QuantSpec(storage=storage, block=block, rounding="stochastic")
    buf = torch.full((1, block), 0.35)
    buf[0, 0] = 1.0                 # fix the absmax, so the grid is known
    trials = 400
    acc = torch.zeros(block)
    for i in range(trials):
        s, sc = packing.quantize_group(
            buf, q, packing._group_generator((0, i), 0, buf.device))
        acc += packing.dequantize_group(s, sc, q)[0]
    step = 1.0 / q.qmax
    np.testing.assert_allclose((acc / trials).numpy(), buf[0].numpy(),
                               atol=0.1 * step)


def test_stochastic_scan_equals_sequential_and_replays():
    K, n, p = 3, 6, 130
    rng = np.random.default_rng(10)
    batches = (torch.from_numpy(rng.standard_normal(
        (K, n, 2, 2, p)).astype(np.float32)),)
    A = torch.from_numpy(rng.random((K, n, n)).astype(np.float32))
    A = A / A.sum(1, keepdim=True)
    tau = torch.ones(K, n)
    m = torch.full((K,), float(n))
    eta = torch.full((K,), 0.1)
    quant = QuantSpec(storage="int4", block=256, rounding="stochastic",
                      seed=3)
    params = {"x": torch.zeros(p)}
    spec = packing.pack_spec({"x": torch.zeros(n, p)}, quant=quant)

    def seq():
        fn = make_round_fn(quad_loss, "aggregate", quant=quant)
        x, qs = params, packing.init_quant_state(spec, n)
        for t in range(K):
            x, _, qs = fn(x, (batches[0][t],), A[t], tau[t], m[t], eta[t],
                          None, qs)
        return x, qs

    a, qa = seq()
    b, qb = seq()
    assert torch.equal(a["x"], b["x"]) and qa[1] == qb[1] == (3, K)
    scanned = make_scanned_rounds(quad_loss, K, "aggregate", quant=quant)
    c, c_seq, qc = scanned(params, batches, A, tau, m, eta, None,
                           packing.init_quant_state(spec, n))
    assert torch.equal(a["x"], c["x"]) and torch.equal(c_seq["x"][-1],
                                                      c["x"])
    assert qc[1] == qa[1]
    assert all(torch.equal(r, s) for r, s in zip(qa[0], qc[0]))


# ---------------------------------------------------------------------------
# mixing: the port's ops (plain versions on the CPU) vs the Pallas kernels
# ---------------------------------------------------------------------------

def _wire_inputs(kw, n=13, seed=5):
    """A quantized ragged-n payload, the reference's and the port's, an A
    with its ELL and the masks."""
    q, jq = _pair(**kw)
    p = 2 * q.block
    rng = np.random.default_rng(seed)
    X = _payload(n, p, q.block, seed, q.qmax)
    stored, scales = packing.quantize_group(torch.from_numpy(X), q)
    jstored, jscales = jpacking.quantize_group(jnp.asarray(X), jq)
    A = np.zeros((n, n), np.float32)
    for i in range(n):
        nbrs = rng.choice(n, size=rng.integers(1, 5), replace=False)
        A[i, nbrs] = rng.random(len(nbrs)).astype(np.float32) + 0.1
    idx, w = SparseA.from_dense(A).ell()
    jidx, jw = JSparseA.from_dense(A).ell()
    assert np.array_equal(idx, jidx) and np.array_equal(w, jw)
    tau = (rng.random(n) < 0.6).astype(np.float32)
    tau[0] = 1.0
    active = (rng.random(n) < 0.8).astype(np.float32)
    weights = rng.random(n).astype(np.float32)
    m = float((tau * active).sum()) or 1.0
    return (q, jq, stored, scales, jstored, jscales, A, idx, w, tau, m,
            active, weights)


def _close(got, want, tol=F32_TOL):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("kw", SPECS[:3], ids=SPEC_IDS[:3])
@pytest.mark.parametrize("masks", ["none", "active_weights"])
def test_quant_ops_match_pallas(kw, masks):
    (q, jq, stored, scales, jstored, jscales, A, idx, w, tau, m, active,
     weights) = _wire_inputs(kw)
    tkw, jkw = {}, {}
    if masks == "active_weights":
        # the rounds' recipe for the mixed leg: zero dropped scale rows
        scales = scales * torch.from_numpy(active)[:, None]
        jscales = jscales * jnp.asarray(active)[:, None]
        tkw = dict(active=torch.from_numpy(active),
                   weights=torch.from_numpy(weights))
        jkw = dict(active=jnp.asarray(active), weights=jnp.asarray(weights))
    targs = (torch.from_numpy(A), torch.from_numpy(tau), torch.tensor(m))
    jargs = (jnp.asarray(A), jnp.asarray(tau), jnp.float32(m))
    sargs = (torch.from_numpy(idx), torch.from_numpy(w)) + targs[1:]
    jsargs = (jnp.asarray(idx), jnp.asarray(w)) + jargs[1:]
    chunk = dict(chunk=2 * q.block)

    mixed, agg = ops.mix_aggregate_q(*targs, stored, scales, quant=q, **tkw)
    jmixed, jagg = jops.mix_aggregate_q(*jargs, jstored, jscales, quant=jq,
                                        **chunk, **jkw)
    assert mixed.dtype == agg.dtype == torch.float32
    _close(mixed, jmixed)
    _close(agg, jagg)
    _close(ops.aggregate_q(*targs, stored, scales, quant=q, **tkw),
           jops.aggregate_q(*jargs, jstored, jscales, quant=jq, **chunk,
                            **jkw))
    mixed, agg = ops.sparse_mix_aggregate_q(*sargs, stored, scales, quant=q,
                                            **tkw)
    jmixed, jagg = jops.sparse_mix_aggregate_q(*jsargs, jstored, jscales,
                                               quant=jq, **chunk, **jkw)
    _close(mixed, jmixed)
    _close(agg, jagg)
    _close(ops.sparse_aggregate_q(*sargs, stored, scales, quant=q, **tkw),
           jops.sparse_aggregate_q(*jsargs, jstored, jscales, quant=jq,
                                   **chunk, **jkw))


def test_quant_grouped_ops_match_pallas():
    (q, jq, stored, scales, jstored, jscales, A, idx, w, tau, m, active,
     _) = _wire_inputs(SPECS[0], seed=8)
    groups = (stored, stored[:, :q.block].contiguous())
    sgroups = (scales, scales[:, :1].contiguous())
    jgroups = (jstored, jstored[:, :q.block])
    jsgroups = (jscales, jscales[:, :1])
    targs = (torch.from_numpy(A), torch.from_numpy(tau), torch.tensor(m))
    jargs = (jnp.asarray(A), jnp.asarray(tau), jnp.float32(m))
    sargs = (torch.from_numpy(idx), torch.from_numpy(w)) + targs[1:]
    jsargs = (jnp.asarray(idx), jnp.asarray(w)) + jargs[1:]
    tact, jact = torch.from_numpy(active), jnp.asarray(active)
    for tfn, jfn, ta, ja in [
            (ops.mix_aggregate_grouped_q, jops.mix_aggregate_grouped_q,
             targs, jargs),
            (ops.sparse_mix_aggregate_grouped_q,
             jops.sparse_mix_aggregate_grouped_q, sargs, jsargs)]:
        got = tfn(*ta, groups, sgroups, quant=q, active=tact)
        want = jfn(*ja, jgroups, jsgroups, quant=jq, chunk=q.block,
                   active=jact)
        for g, w_ in zip(got[0] + got[1], want[0] + want[1]):
            _close(g, w_)
    for tfn, jfn, ta, ja in [
            (ops.aggregate_grouped_q, jops.aggregate_grouped_q, targs,
             jargs),
            (ops.sparse_aggregate_grouped_q, jops.sparse_aggregate_grouped_q,
             sargs, jsargs)]:
        for g, w_ in zip(tfn(*ta, groups, sgroups, quant=q, active=tact),
                         jfn(*ja, jgroups, jsgroups, quant=jq,
                             chunk=q.block, active=jact)):
            _close(g, w_)


def test_dequant_wrappers_use_plain_versions_on_cpu():
    (q, _, stored, scales, _, _, A, idx, w, _, _, _, _) = \
        _wire_inputs(SPECS[1])
    counters = (fused.aggregate_dequant_cuda,
                fused.mix_aggregate_dequant_cuda,
                sparse.sparse_mix_aggregate_dequant_cuda)
    before = [f.launches for f in counters]
    kw = dict(storage=q.storage, block=q.block)
    wrow = torch.rand(13)
    tidx, tw = torch.from_numpy(idx), torch.from_numpy(w)
    assert torch.equal(
        fused.aggregate_dequant_cuda(wrow, stored, scales, **kw),
        ref.aggregate_dequant_ref(wrow, stored, scales, **kw))
    got = sparse.sparse_mix_aggregate_dequant_cuda(tidx, tw, wrow, stored,
                                                   scales, **kw)
    want = ref.sparse_mix_aggregate_dequant_ref(tidx, tw, wrow, stored,
                                                scales, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    fused.mix_aggregate_dequant_cuda(torch.from_numpy(A), wrow, stored,
                                     scales, **kw)
    assert [f.launches for f in counters] == before
    # the geometry checks hold on every device
    with pytest.raises(ValueError, match="values a row"):
        fused.aggregate_dequant_cuda(wrow, stored[:, :64], scales, **kw)
    with pytest.raises(TypeError):
        fused.aggregate_dequant_cuda(wrow, stored, scales, storage="fp8",
                                     block=256)
    with pytest.raises(ValueError, match="multiple of 256"):
        fused.aggregate_dequant_cuda(wrow, stored, scales, storage="int4",
                                     block=128)


# ---------------------------------------------------------------------------
# rounds: every quant backend vs the reference's make_round_fn(quant=)
# ---------------------------------------------------------------------------

def _round_inputs(model, seed=9, n=6, T=2, B=3, hw=8):
    rng = np.random.default_rng(seed)
    init = {"cnn": (jcnn.init_cnn, dict(image_hw=hw)),
            "logreg": (jcnn.init_logreg, dict(d_in=hw * hw))}[model]
    jparams = init[0](0, **init[1])
    x = rng.random((n, T, B, hw, hw, 1)).astype(np.float32)
    y = rng.integers(0, 10, (n, T, B)).astype(np.int32)
    A = rng.random((n, n)).astype(np.float32)
    A = A / A.sum(0, keepdims=True)
    tau = (rng.random(n) < 0.7).astype(np.float32)
    active = (rng.random(n) < 0.8).astype(np.float32)
    active[0] = tau[0] = 1.0
    m = np.float32(max(1.0, (tau * active).sum()))
    return jparams, x, y, A, tau, m, active


def _flips_allowed(got, want, allow, tol=F32_TOL):
    """``got`` allclose ``want``, except that values may differ by up to
    ``allow`` (the effect of a flipped rounding decision); returns how
    many values needed the allowance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    off = ~np.isclose(got, want, **tol)
    assert (np.abs(got - want)[off] <= np.asarray(allow)[off]).all()
    return int(off.sum())


@pytest.mark.parametrize("model", ["logreg", "cnn"])
@pytest.mark.parametrize("backend", QUANT_BACKENDS)
def test_quant_round_fn_matches_reference(model, backend):
    jparams, x, y, A, tau, m, active = _round_inputs(model)
    n = A.shape[0]
    japply, tapply = ((jcnn.cnn_apply, cnn.cnn_apply) if model == "cnn"
                      else (jcnn.logreg_apply, cnn.logreg_apply))
    loss = partial(cnn.l2_regularized_loss, tapply)
    q, jq = _pair(storage="int8", block=128)
    if backend.startswith("sparse"):
        idx, w = SparseA.from_dense(A).ell()
        jA, tA = ((jnp.asarray(idx), jnp.asarray(w)),
                  (torch.from_numpy(idx), torch.from_numpy(w)))
    else:
        jA, tA = jnp.asarray(A), torch.from_numpy(A)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams))
    spec = packing.pack_spec(jax.tree.map(
        lambda p: torch.empty((n,) + tuple(p.shape), device="meta"),
        params), quant=q)
    jspec = jpacking.pack_spec(jax.tree.map(
        lambda p: jax.ShapeDtypeStruct((n,) + p.shape, p.dtype), jparams),
        quant=jq)
    jfn = jmake_round_fn(partial(jcnn.l2_regularized_loss, japply),
                         mixing_backend=backend, chunk=512, quant=jq)
    fn = make_round_fn(loss, backend, quant=q)
    jstate = jpacking.init_quant_state(jspec, n)
    state = packing.init_quant_state(spec, n)
    batch = (torch.from_numpy(x), torch.from_numpy(y).long())
    targs = (torch.from_numpy(tau), torch.tensor(m))
    wrow = ops.combine_weights(torch.from_numpy(A), *targs,
                               torch.from_numpy(active)).abs()
    jp, p = jparams, params
    flips, allow = 0, torch.zeros(spec.padded)
    for _ in range(2):                      # round 1 carries residuals
        # one grid step of every value: the scale of its block, as the
        # port's quantizer sets it this round
        xq = packing.pack(client_deltas(loss, p, batch, torch.tensor(
            0.05)), spec)[0] + state[0][0]
        steps = (xq.reshape(n, -1, q.block).abs().amax(2) / q.qmax) \
            .repeat_interleave(q.block, 1)
        allow += wrow @ steps               # every client flipping there
        jp, jmixed, jstate = jfn(
            jp, (jnp.asarray(x), jnp.asarray(y)), jA, jnp.asarray(tau),
            jnp.float32(m), jnp.float32(0.05), jnp.asarray(active), jstate)
        p, mixed, state = fn(p, batch, tA, *targs, torch.tensor(0.05),
                             torch.from_numpy(active), state)
        assert (mixed is None) == (jmixed is None)
        flips += _flips_allowed(state[0][0].numpy(), jstate[0][0],
                                steps.numpy() * (1 + 1e-5))
    allow = tree_flatten(packing.unpack_row(allow * 1.01 + 1e-7, spec))[0]
    for a, b, c in zip(tree_flatten(p)[0], jax.tree.leaves(jp), allow):
        flips += _flips_allowed(a.numpy(), b, c.numpy(),
                                dict(rtol=1e-4, atol=1e-5))
    assert flips <= 1e-3 * spec.padded * n


@pytest.mark.parametrize("backend", QUANT_BACKENDS)
def test_quant_scan_equals_sequential_bitwise(backend):
    plan, _ = _plans("k_regular", "markov", sparse=True)
    plan = plan.with_quant(QuantSpec(storage="int4", block=256))
    if not backend.startswith("sparse"):
        plan = plan.densify()
    batches = [(torch.from_numpy(b),) for b in _batches(plan.n_clients,
                                                         plan.n_rounds,
                                                         p=300)]
    out = []
    for scan in (False, True):
        eng = make_engine(ExecutionConfig(
            backend=backend, scan=scan,
            record_mixed=backend in ("fused", "sparse")), quad_loss,
            device="cpu")
        out.append(eng.execute(plan, {"x": torch.zeros(300)}, batches)[0])
    assert torch.equal(out[0]["x"], out[1]["x"])


def test_engine_quant_sources_agree_and_quant_engages():
    plan, jplan = _plans("k_regular", "iid", sparse=False)
    q, jq = _pair(storage="int8", block=128)
    batches = _batches(plan.n_clients, plan.n_rounds, p=200)
    tb = [(torch.from_numpy(b),) for b in batches]

    def run(cfg, pl):
        return make_engine(cfg, quad_loss, device="cpu").execute(
            pl, {"x": torch.zeros(200)}, tb)[0]["x"]

    via_cfg = run(ExecutionConfig(backend="aggregate", quant=q), plan)
    via_plan = run(ExecutionConfig(backend="aggregate"), plan.with_quant(q))
    assert torch.equal(via_cfg, via_plan)
    fp32 = run(ExecutionConfig(backend="aggregate"), plan)
    assert (fp32 - via_cfg).abs().max() > 0
    jfinal, _ = jmake_engine(JExec(backend="aggregate", chunk=128, quant=jq),
                             jquad_loss).execute(
        jplan, {"x": jnp.zeros(200)}, [(jnp.asarray(b),) for b in batches])
    np.testing.assert_allclose(via_cfg.numpy(), np.asarray(jfinal["x"]),
                               rtol=1e-5, atol=1e-5)


def test_quant_round_fn_requires_qstate_and_a_quant_backend():
    with pytest.raises(ValueError, match="quantized rounds"):
        make_round_fn(quad_loss, "pallas", quant=QuantSpec())
    fn = make_round_fn(quad_loss, "einsum", quant=QuantSpec(block=128))
    with pytest.raises(ValueError, match="quantizer state"):
        fn({"x": torch.zeros(3)}, (torch.zeros(2, 1, 1, 3),),
           torch.eye(2), torch.ones(2), torch.tensor(2.0),
           torch.tensor(0.1))


# ---------------------------------------------------------------------------
# plans and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sparse_plan", [False, True])
def test_plan_json_with_quant_is_byte_identical(sparse_plan):
    plan, jplan = _plans("ring", "markov", sparse=sparse_plan)
    kw = dict(storage="int4", block=512, error_feedback=False, seed=2)
    q, jq = _pair(**kw)
    text = plan.with_quant(q).to_json()
    assert text == jplan.with_quant(jq).to_json()
    back = type(plan).from_json(text)
    assert back.quant == q and back.allclose(plan.with_quant(q))
    assert not back.allclose(plan)
    d = json.loads(plan.to_json())       # a v4 payload loads unquantized
    d["version"] = 4
    d.pop("quant")
    assert type(plan).from_json(json.dumps(d)).quant is None


def test_cli_quant_matches_reference_comm_cost_and_plan(tmp_path):
    args = ["--model", "logreg", "--rounds", "2", "--n", "10",
            "--clusters", "2", "--k-min", "2", "--k-max", "3", "--samples",
            "200", "--T", "2", "--batch", "4", "--quiet", "--dropout", "0.2",
            "--quant", "int8", "--quant-block", "256"]
    outs = {}
    for name, main, extra in [("port", train.main, ["--device", "cpu"]),
                              ("ref", jtrain.main, [])]:
        out, plan = tmp_path / f"{name}.json", tmp_path / f"{name}.plan"
        assert main(args + extra + ["--backend", "fused", "--out", str(out),
                                    "--plan-out", str(plan)]) == 0
        outs[name] = (json.loads(out.read_text()), plan.read_text())
    (port, port_plan), (jref, ref_plan) = outs["port"], outs["ref"]
    assert port["total_cost"] == jref["total_cost"]
    assert [r["d2s"] for r in port["rounds"]] == \
        [r["d2s"] for r in jref["rounds"]]
    assert port_plan == ref_plan
    assert json.loads(port_plan)["quant"]["storage"] == "int8"
    np.testing.assert_allclose([r["test_loss"] for r in port["rounds"]],
                               [r["test_loss"] for r in jref["rounds"]],
                               rtol=1e-4)
    # the saved plan replays with its spec, without the flags
    replay = tmp_path / "replay.json"
    assert train.main(args[:-6] + ["--device", "cpu", "--backend", "sparse",
                                   "--plan", str(tmp_path / "port.plan"),
                                   "--out", str(replay)]) == 0
    assert json.loads(replay.read_text())["total_cost"] == port["total_cost"]
