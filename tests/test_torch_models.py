"""Models and local SGD of the PyTorch port against the JAX reference.

The port keeps the reference's NHWC/HWIO parameter layout, so the same
weights give the same logits -- in particular ``cnn_apply`` must flatten
its activations in NHWC order before ``fc1`` (torch convolutions run in
NCHW).  Init draws the same numpy stream, so the initial weights are
bitwise equal.  Forward values, losses, gradients and the per-client
deltas of T local SGD steps are ``allclose``: ``rtol=atol=1e-5`` for
forward values (logits of magnitude ~1 summed over up to 3136 products
per layer, in another order), ``rtol=1e-4, atol=1e-5`` for gradients and
deltas, which compose several such reductions.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rounds import client_deltas as jclient_deltas
from repro.models import cnn as jcnn
from repro_torch.core.pytree import tree_flatten
from repro_torch.core.rounds import client_deltas
from repro_torch.models import cnn
from repro_torch.models.convert import params_from_numpy, params_to_numpy

jax.config.update("jax_enable_x64", False)

FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=1e-4, atol=1e-5)
HW = 8
MODELS = {
    "cnn": (jcnn.init_cnn, cnn.init_cnn, jcnn.cnn_apply, cnn.cnn_apply,
            dict(image_hw=HW)),
    "mlp": (jcnn.init_mlp, cnn.init_mlp, jcnn.mlp_apply, cnn.mlp_apply,
            dict(d_in=HW * HW)),
    "logreg": (jcnn.init_logreg, cnn.init_logreg, jcnn.logreg_apply,
               cnn.logreg_apply, dict(d_in=HW * HW)),
}


def _leaves_np(tree):
    if isinstance(tree, dict) and tree and isinstance(
            tree_flatten(tree)[0][0], torch.Tensor):
        tree = params_to_numpy(tree)
        return tree_flatten(tree)[0]
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_init_is_bitwise_and_forward_matches(model):
    jinit, tinit, japply, tapply, kw = MODELS[model]
    jp, tp = jinit(3, **kw), tinit(3, **kw)
    for a, b in zip(_leaves_np(tp), _leaves_np(jp)):
        np.testing.assert_array_equal(a, b)
    x = np.random.default_rng(0).standard_normal((5, HW, HW, 1)) \
        .astype(np.float32)
    y = np.arange(5) % 10
    np.testing.assert_allclose(tapply(tp, torch.from_numpy(x)).numpy(),
                               np.asarray(japply(jp, jnp.asarray(x))), **FWD)
    tl = cnn.l2_regularized_loss(tapply, tp, (torch.from_numpy(x),
                                              torch.from_numpy(y)))
    jl = jcnn.l2_regularized_loss(japply, jp, (jnp.asarray(x),
                                               jnp.asarray(y, jnp.int32)))
    np.testing.assert_allclose(float(tl), float(jl), **FWD)

    tg = torch.func.grad(partial(cnn.l2_regularized_loss, tapply))(
        tp, (torch.from_numpy(x), torch.from_numpy(y)))
    jg = jax.grad(partial(jcnn.l2_regularized_loss, japply))(
        jp, (jnp.asarray(x), jnp.asarray(y, jnp.int32)))
    for a, b in zip(_leaves_np(tg), _leaves_np(jg)):
        np.testing.assert_allclose(a, b, **GRAD)


def test_cnn_flattens_nhwc_before_fc1():
    """A feature-order bug would still produce logits of the right shape;
    pin that fc1 sees the reference's NHWC order."""
    p = cnn.init_cnn(0, image_hw=HW)
    x = torch.randn(2, HW, HW, 1, generator=torch.Generator().manual_seed(0))
    jp = jcnn.init_cnn(0, image_hw=HW)
    want = np.asarray(jcnn.cnn_apply(jp, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(cnn.cnn_apply(p, x).numpy(), want, **FWD)
    # the same weights read in NCHW order disagree: the check has teeth
    p_bad = dict(p, fc1=dict(p["fc1"], w=p["fc1"]["w"].reshape(
        2, 2, 64, 512).permute(2, 0, 1, 3).reshape(-1, 512)))
    assert not np.allclose(cnn.cnn_apply(p_bad, x).numpy(), want, **FWD)


@pytest.mark.parametrize("model", ["cnn", "logreg"])
def test_client_deltas_match_reference(model):
    jinit, _, japply, tapply, kw = MODELS[model]
    jp = jinit(1, **kw)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(2)
    n, T, B = 3, 2, 4
    x = rng.standard_normal((n, T, B, HW, HW, 1)).astype(np.float32)
    y = rng.integers(0, 10, (n, T, B))
    got = client_deltas(partial(cnn.l2_regularized_loss, tapply), tp,
                        (torch.from_numpy(x), torch.from_numpy(y)),
                        torch.tensor(0.1))
    want = jclient_deltas(partial(jcnn.l2_regularized_loss, japply), jp,
                          (jnp.asarray(x), jnp.asarray(y, jnp.int32)),
                          jnp.float32(0.1))
    for a, b in zip(_leaves_np(got), _leaves_np(want)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **GRAD)


def test_convert_round_trips_bf16_exactly():
    tree = {"b": np.linspace(-3, 3, 7, dtype=np.float32),
            "a": {"w": np.asarray(jnp.asarray(np.arange(6.) / 7,
                                              jnp.bfloat16))}}
    t = params_from_numpy(tree)
    assert t["a"]["w"].dtype == torch.bfloat16
    back = params_to_numpy(t)
    np.testing.assert_array_equal(back["b"], tree["b"])
    np.testing.assert_array_equal(back["a"]["w"],
                                  tree["a"]["w"].astype(np.float32))
