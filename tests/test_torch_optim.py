"""``repro_torch.optim`` against ``repro.optim`` on the CPU.

The schedules are pure Python in both packages and must be equal.  Each
optimizer's ``update`` runs 3 steps from the same numpy params and
gradients in both frameworks; params and states are ``allclose`` with
``rtol=1e-5, atol=1e-6`` (fp32 elementwise arithmetic; XLA's and torch's
``pow`` / ``sqrt`` / division may round differently in the last place,
and three Adam steps carry that forward).  Then the twins of the
reference's heterogeneity pins (``tests/test_hetero_optim.py``): parsing,
shapes and dtypes, all-SGD == ``client_deltas``, Adam's state advancing,
``warmup`` leaving state alone, determinism given the dispatch order --
and ``HeteroClientOptimizers`` against the reference's over 2 calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.optim import hetero as jhetero
from repro_torch import optim
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.core.rounds import client_deltas
from repro_torch.optim import (CLIENT_OPTIMIZERS, AdamState,
                               HeteroClientOptimizers, parse_client_optim)

jax.config.update("jax_enable_x64", False)

TOL = dict(rtol=1e-5, atol=1e-6)


def _np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _tnp(tree):
    return [x.detach().numpy() for x in tree_leaves(tree)]


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("constant", (0.05,)), ("exponential", (0.02, 0.1)),
    ("paper_experimental", ()), ("inverse_time", (4.0, 7.0)),
    ("cosine", (0.1, 20, 0.001)), ("warmup_cosine", (0.1, 3, 20, 0.001))])
def test_schedules_equal_the_reference(name, args):
    mine = getattr(optim, name)(*args)
    ref = getattr(joptim, name)(*args)
    assert [mine(t) for t in range(25)] == [ref(t) for t in range(25)]


# ---------------------------------------------------------------------------
# optimizers: 3 steps of update against the reference
# ---------------------------------------------------------------------------

def _params_and_grads(seed=0, steps=3):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((3, 5)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("momentum", {}), ("momentum", {"nesterov": True}),
    ("adam", {}), ("adam", {"weight_decay": 0.05}), ("adamw", {})])
def test_update_matches_the_reference_over_three_steps(name, kw):
    params, grads = _params_and_grads()
    opt, jopt = getattr(optim, name)(**kw), getattr(joptim, name)(**kw)
    p = tree_map(torch.as_tensor, params)
    jp = jax.tree.map(jnp.asarray, params)
    s, js = opt.init(p), jopt.init(jp)
    lr, jlr = torch.tensor(0.05), jnp.asarray(0.05, jnp.float32)
    for g in grads:
        p, s = opt.update(tree_map(torch.as_tensor, g), s, p, lr)
        jp, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp, jlr)
        for a, b in zip(_tnp(p), _np(jp)):
            np.testing.assert_allclose(a, b, **TOL)
    mine, ref = _tnp(s), _np(js)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a.dtype == b.dtype
        np.testing.assert_allclose(a, b, **TOL)
    if name.startswith("adam"):
        assert isinstance(s, AdamState) and s.count.dtype == torch.int32
        assert int(s.count) == 3


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    _, grads = _params_and_grads(seed=1, steps=1)
    mine = optim.clip_by_global_norm(tree_map(torch.as_tensor, grads[0]),
                                     max_norm)
    ref = joptim.clip_by_global_norm(jax.tree.map(jnp.asarray, grads[0]),
                                     max_norm)
    for a, b in zip(_tnp(mine), _np(ref)):
        np.testing.assert_allclose(a, b, **TOL)


def test_adam_state_is_a_node_of_the_ports_pytrees():
    st = optim.adam().init({"x": torch.zeros(3)})
    again = tree_map(lambda x: x + 1, st)
    assert isinstance(again, AdamState)
    assert [int(x.sum()) for x in tree_leaves(again)] == [3, 3, 1]


# ---------------------------------------------------------------------------
# heterogeneity: the twins of the reference's pins
# ---------------------------------------------------------------------------

def quad_loss(params, batch):
    x = params["x"]
    b, = batch
    return 0.5 * torch.sum((x - b.mean(dim=0)) ** 2)


def jquad_loss(params, batch):
    x = params["x"]
    b, = batch
    return 0.5 * jnp.sum((x - b.mean(axis=0)) ** 2)


def _round_batches(n=6, T=3, p=4, seed=0):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.standard_normal((n, T, 2, p)),
                            dtype=torch.float32),)


def _hetero(spec, n, params):
    return HeteroClientOptimizers(quad_loss, params,
                                  parse_client_optim(spec, n), device="cpu")


def test_parse_client_optim_single_and_round_robin():
    assert parse_client_optim("sgd", 3) == ("sgd", "sgd", "sgd")
    assert parse_client_optim("sgd,adam", 5) == \
        ("sgd", "adam", "sgd", "adam", "sgd")
    assert parse_client_optim(" sgd , adam ", 2) == ("sgd", "adam")
    assert parse_client_optim("adam,sgd,momentum", 7) == \
        jhetero.parse_client_optim("adam,sgd,momentum", 7)


def test_parse_client_optim_rejects_unknown_and_empty():
    with pytest.raises(ValueError, match="unknown"):
        parse_client_optim("sgd,nadam", 4)
    with pytest.raises(ValueError, match="empty"):
        parse_client_optim(" , ", 4)
    assert set(CLIENT_OPTIMIZERS) == {"sgd", "momentum", "adam", "adamw"}


def test_hetero_runs_on_cuda_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HeteroClientOptimizers(quad_loss, {"x": torch.zeros(4)},
                               ("sgd",) * 3)
    h = _hetero("sgd", 3, {"x": torch.zeros(4)})
    assert h.device == torch.device("cpu")


def test_deltas_shapes_and_dtype():
    n, p = 6, 4
    params = {"x": torch.zeros(p)}
    h = _hetero("sgd,adam", n, params)
    d = h.deltas(params, _round_batches(n), 0.1)
    assert d["x"].shape == (n, p) and d["x"].dtype == torch.float32
    # groups sorted by name, each state stacked over its group
    assert list(h.states) == ["adam", "sgd"]
    assert h.states["adam"].mu["x"].shape == (3, p)


def test_all_sgd_matches_client_deltas_oracle():
    n, p = 6, 4
    params = {"x": torch.ones(p)}
    batches = _round_batches(n)
    d_h = _hetero("sgd", n, params).deltas(params, batches, 0.2)
    d_o = client_deltas(quad_loss, params, batches, torch.tensor(0.2))
    np.testing.assert_allclose(d_h["x"].numpy(), d_o["x"].numpy(),
                               rtol=1e-6, atol=1e-7)


def test_adam_state_advances_and_changes_deltas():
    n, p = 4, 4
    params = {"x": torch.ones(p)}
    batches = _round_batches(n)
    h = _hetero("adam", n, params)
    s0 = [x.clone() for x in tree_leaves(h.states)]
    d1 = h.deltas(params, batches, 0.1)
    s1 = tree_leaves(h.states)
    assert any(not torch.equal(a, b) for a, b in zip(s0, s1)), \
        "state must advance"
    # same inputs, evolved state: Adam's moments make the second call
    # produce different deltas (a pure-SGD runner would repeat itself)
    d2 = h.deltas(params, batches, 0.1)
    assert not torch.equal(d1["x"], d2["x"])


def test_warmup_does_not_advance_state():
    n, p = 4, 4
    params = {"x": torch.ones(p)}
    batches = _round_batches(n)
    h = _hetero("sgd,adam", n, params)
    before = [x.clone() for x in tree_leaves(h.states)]
    h.warmup(params, batches, 0.1)
    assert all(torch.equal(a, b)
               for a, b in zip(before, tree_leaves(h.states)))


def test_deltas_deterministic_given_dispatch_order():
    n, p = 6, 4
    params = {"x": torch.ones(p)}
    seq = [_round_batches(n, seed=s) for s in range(3)]

    def run():
        h = _hetero("sgd,adam", n, params)
        return [h.deltas(params, b, 0.1)["x"] for b in seq]

    for a, b in zip(run(), run()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("spec", ["sgd,momentum,adam,adamw",
                                  "adamw,sgd"])
def test_hetero_matches_the_reference_over_two_calls(spec):
    n, p = 8, 4
    x0 = np.linspace(-1.0, 1.0, p).astype(np.float32)
    h = _hetero(spec, n, {"x": torch.as_tensor(x0)})
    jh = jhetero.HeteroClientOptimizers(
        jquad_loss, {"x": jnp.asarray(x0)},
        jhetero.parse_client_optim(spec, n))
    for call in range(2):
        b = _round_batches(n, seed=call)
        gp = x0 + 0.1 * call
        d = h.deltas({"x": torch.as_tensor(gp)}, b, 0.1)
        jd = jh.deltas({"x": jnp.asarray(gp)}, (jnp.asarray(b[0].numpy()),),
                       0.1)
        np.testing.assert_allclose(d["x"].numpy(), np.asarray(jd["x"]),
                                   **TOL)
    assert list(h.states) == list(jh.states)
    for name in h.states:
        mine, ref = _tnp(h.states[name]), _np(jh.states[name])
        assert len(mine) == len(ref)
        for a, r in zip(mine, ref):
            np.testing.assert_allclose(a, r, **TOL)
