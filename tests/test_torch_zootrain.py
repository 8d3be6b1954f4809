"""Federated training of the SSD, hybrid and MLA + MoE families in the port
against the JAX reference on the CPU: ``test_torch_lmtrain.py``'s backend
sweep (every ``MIXING_BACKENDS`` entry, sequential and scanned, against
the reference's ``make_round_fn`` / ``make_scanned_rounds(model.loss)``)
and its quantized cases on 'einsum' / 'fused', carried to the reduced
mamba2-1.3b, zamba2-2.7b (two groups, so the shared block's gradient
comes from two call sites) and deepseek-v2-236b (MLA, dense first layer,
routed + shared experts; dense under vmap, as the reference's reduced MoE
configs train).  The oracle helpers and tolerances are
``test_torch_lmtrain.py``'s: every round ``rtol=2e-4, atol=2e-5``;
quantized rounds the same with one grid step where a rounding decision
flipped, counted and kept rare; here a client's previous grid step counts
too (``_quant_oracle(carry=True)``): zamba2's round 0 leaves one client,
unsampled and unmixed then (weight 0), a payload value at a rounding
midpoint (-23.5 grid steps), which the two quantizers round either way,
and its error-feedback residual sends the difference in round 1.  A pin within the port: a bf16 mamba2
round packs two dtype groups (the SSD's fp32 ``dt_bias`` / ``A_log`` /
``D``), so each kernel backend launches its kernel twice a round."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.pytree import tree_flatten_with_paths, tree_leaves, \
    tree_map
from repro_torch.core.rounds import MIXING_BACKENDS, make_round_fn, \
    make_scanned_rounds
from repro_torch.fl import packing
from repro_torch.kernels.mixing import ops
from repro_torch.models.blocks import hybrid_groups
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model
from repro.models.model import Model as JModel
from test_torch_lmtrain import (K, N, ORACLE, QUANT, _A_arg, _cfgs, _close,
                                _flips_allowed, _oracle, _quant,
                                _quant_oracle, _t, _trajectory)

ZOO_ARCHS = ("mamba2-1.3b", "zamba2-2.7b", "deepseek-v2-236b")


def test_reduced_zamba2_runs_two_groups():
    """The reduced hybrid config is two groups (of one Mamba block each)
    around the one shared attention block."""
    _, cfg = _cfgs("zamba2-2.7b")
    assert hybrid_groups(cfg) == (2, 1)


@pytest.mark.parametrize("arch", ZOO_ARCHS)
@pytest.mark.parametrize("backend", MIXING_BACKENDS)
@pytest.mark.parametrize("scan", [False, True], ids=["seq", "scan"])
def test_backend_matches_the_reference(arch, backend, scan):
    _, cfg = _cfgs(arch)
    jp, (batch, A, tau, m, eta), seq = _oracle(arch, K)
    loss = Model(cfg, device="cpu").loss
    p0 = params_from_numpy(jp, "cpu")
    if scan:
        _, ps = make_scanned_rounds(loss, K, backend)(
            p0, _t(batch), _A_arg(backend, A), *_t((tau, m, eta)))
        outs = [tree_map(lambda x: x[t], ps) for t in range(K)]
    else:
        fn, p, outs = make_round_fn(loss, backend), p0, []
        for t in range(K):
            p, _ = fn(p, tuple(torch.from_numpy(b[t]) for b in batch),
                      _A_arg(backend, A[t]), torch.from_numpy(tau[t]),
                      torch.tensor(m[t]), torch.tensor(eta[t]))
            outs.append(p)
    for t in range(K):
        _close(outs[t], seq[t])


@pytest.mark.parametrize("arch", ZOO_ARCHS)
@pytest.mark.parametrize("backend", QUANT)
@pytest.mark.parametrize("scan", [False, True], ids=["seq", "scan"])
def test_quantized_backend_matches_the_reference(arch, backend, scan):
    _, cfg = _cfgs(arch)
    jp, (batch, A, tau, m, eta), _ = _oracle(arch, K)
    ref = _quant_oracle(arch, carry=True)
    loss = Model(cfg, device="cpu").loss
    q = _quant(packing.QuantSpec)
    p0 = params_from_numpy(jp, "cpu")
    spec = packing.pack_spec(tree_map(
        lambda x: torch.empty((N,) + tuple(x.shape), device="meta"), p0),
        quant=q)
    state = packing.init_quant_state(spec, N)
    if scan:
        _, ps, _ = make_scanned_rounds(loss, K, backend, quant=q)(
            p0, _t(batch), torch.from_numpy(A), *_t((tau, m, eta)), None,
            state)
        outs = [tree_map(lambda x: x[t], ps) for t in range(K)]
    else:
        fn, p, outs = make_round_fn(loss, backend, quant=q), p0, []
        for t in range(K):
            p, _, state = fn(p, tuple(torch.from_numpy(b[t])
                                      for b in batch),
                             torch.from_numpy(A[t]),
                             torch.from_numpy(tau[t]), torch.tensor(m[t]),
                             torch.tensor(eta[t]), None, state)
            outs.append(p)
    flips = total = 0
    for t in range(K):
        want, allow = ref[t]
        for a, w, al in zip(tree_leaves(outs[t]), want, allow):
            flips += _flips_allowed(a.numpy(), w, al, ORACLE)
            total += a.numpy().size
    assert flips <= 1e-3 * total


@pytest.mark.parametrize("backend,kernel", [("aggregate", "aggregate_cuda"),
                                            ("fused", "mix_aggregate_cuda")])
def test_bf16_mamba2_round_packs_two_dtype_groups(monkeypatch, backend,
                                                  kernel):
    """In bf16 the SSD keeps ``dt_bias``, ``A_log`` and ``D`` in fp32: the
    payload packs a bf16 and an fp32 group, each kernel backend calls its
    kernel's wrapper once a group a round, and every leaf keeps its
    dtype."""
    cfg = dataclasses.replace(get_config("mamba2-1.3b", reduced=True),
                              dtype="bfloat16")
    model = Model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    spec = packing.pack_spec(params)
    assert spec.n_groups == 2
    fp32 = {k.split("/")[-1] for k, x in tree_flatten_with_paths(params)[0]
            if x.dtype == torch.float32}
    assert fp32 == {"dt_bias", "A_log", "D"}
    calls = []
    wrapper = getattr(ops, kernel)
    monkeypatch.setattr(ops, kernel, lambda *a: calls.append(
        a[-1].dtype) or wrapper(*a))
    batch, A, tau, m, eta = _trajectory(cfg, 1)
    b = tuple(torch.from_numpy(x[0]) for x in batch)
    out = make_round_fn(model.loss, backend)(
        params, b, torch.from_numpy(A[0]), torch.from_numpy(tau[0]),
        torch.tensor(m[0]), torch.tensor(eta[0]))[0]
    assert calls == [torch.bfloat16, torch.float32]
    for a, x in zip(tree_leaves(out), tree_leaves(params)):
        assert a.dtype == x.dtype and bool(torch.isfinite(a.float()).all())
    assert not all(torch.equal(a, x) for a, x in zip(tree_leaves(out),
                                                      tree_leaves(params)))


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """Inside a chunk ``exp(cum[q] - cum[s])`` overflows above the
    diagonal once dt |A| sums past 88.7 (at the published chunk of 128 it
    does: both packages' mamba2-1.3b gradients are NaN there with the
    reference's form).  The reference drops those entries by a where after
    the exp, so its forward is finite and its gradient NaN; the port masks
    the exponent before the exp.  Here the reduced mamba2 with A = -300
    overflows in one chunk of 16 tokens: the port's loss equals the reference's,
    and its gradient equals the reference's at a chunk of 1, where no
    entry lies above a diagonal (the chunked scan is exact at any
    chunk)."""
    jcfg, cfg = _cfgs("mamba2-1.3b")
    jp = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.key(0)))
    ssm = jp["decoder"]["layers"]["ssm"]
    ssm["A_log"] = np.full_like(ssm["A_log"], np.log(300.0))
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, 17)).astype(np.int32)
    jb = (jnp.asarray(toks[:, :-1]), jnp.asarray(toks[:, 1:]))
    loss_ref, g_ref = jax.value_and_grad(JModel(jcfg).loss)(jp, jb)
    assert not all(np.isfinite(np.asarray(x)).all()
                   for x in jax.tree.leaves(g_ref))
    _, g_exact = jax.value_and_grad(JModel(dataclasses.replace(
        jcfg, ssm_chunk=1)).loss)(jp, jb)
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(g_exact))
    grads, loss = torch.func.grad_and_value(Model(cfg, device="cpu").loss)(
        params_from_numpy(jp, "cpu"),
        (torch.from_numpy(toks[:, :-1]), torch.from_numpy(toks[:, 1:])))
    np.testing.assert_allclose(float(loss), float(loss_ref), **ORACLE)
    _close(grads, [np.asarray(x) for x in jax.tree.leaves(g_exact)])
