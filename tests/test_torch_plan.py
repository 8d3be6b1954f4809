"""Host-side planning of the PyTorch port against the JAX reference.

Planning is numpy in both packages and draws ``default_rng(seed)`` in the
same order, so the plans must be equal byte for byte: the same topology
spec and seed give the same ``RoundPlan.to_json()`` text, through every
dense constructor and the straggler transforms, and ``regenerate()``
rebuilds the same columns.  (Sparse plans and the other families:
``test_torch_topology.py``.)
"""

import numpy as np
import pytest

from repro import topology as jtopology
from repro.core.server import ServerConfig as JServerConfig
from repro.fl.plan import RoundPlan as JRoundPlan
from repro_torch import topology
from repro_torch.core.server import ServerConfig
from repro_torch.fl.plan import RoundPlan


def _pair(seed, n=70, c=7, t_max=6, bound_kind="auto", **kw):
    params = dict(k_range=(6, 9), p_fail=0.1)
    spec = topology.make_spec("k_regular", n=n, c=c, **params)
    jspec = jtopology.make_spec("k_regular", n=n, c=c, **params)
    cfg = dict(T=5, t_max=t_max, phi_max=0.06, seed=seed,
               bound_kind=bound_kind, **kw)
    return (spec.build(), ServerConfig(**cfg),
            jspec.build(), JServerConfig(**cfg))


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
def test_connectivity_aware_json_is_byte_identical(seed):
    net, cfg, jnet, jcfg = _pair(seed)
    plan = RoundPlan.connectivity_aware(net, cfg)
    jplan = JRoundPlan.connectivity_aware(jnet, jcfg)
    assert plan.to_json() == jplan.to_json()


@pytest.mark.parametrize("ctor,extra", [
    ("fedavg", dict(m_fixed=20)), ("colrel", dict(m_fixed=20)),
    ("connectivity_aware", dict(bound_kind="exact")),
    ("connectivity_aware", dict(m0=15, phi_max=0.2))])
def test_other_constructors_are_byte_identical(ctor, extra):
    extra = dict(extra)
    phi = extra.pop("phi_max", 0.06)
    net, cfg, jnet, jcfg = _pair(3, n=20, c=2, t_max=4, **extra)
    cfg.phi_max = jcfg.phi_max = phi
    plan = getattr(RoundPlan, ctor)(net, cfg)
    jplan = getattr(JRoundPlan, ctor)(jnet, jcfg)
    assert plan.to_json() == jplan.to_json()


@pytest.mark.parametrize("seed", [0, 5])
def test_dropout_regenerate_and_slices_are_byte_identical(seed):
    net, cfg, jnet, jcfg = _pair(seed, n=30, c=3, t_max=5)
    plan = RoundPlan.connectivity_aware(net, cfg)
    jplan = JRoundPlan.connectivity_aware(jnet, jcfg)
    drop = plan.with_dropout(0.3, np.random.default_rng(seed + 1))
    jdrop = jplan.with_dropout(0.3, np.random.default_rng(seed + 1))
    assert drop.has_dropout
    assert drop.to_json() == jdrop.to_json()
    assert drop.regenerate().to_json() == jdrop.regenerate().to_json()
    assert drop.regenerate().allclose(drop)
    assert drop[2:].to_json() == jdrop[2:].to_json()
    mask = np.ones_like(plan.active_t)
    mask[1] = 0.0
    assert plan.with_active(mask).to_json() == \
        jplan.with_active(mask).to_json()
    back = RoundPlan.from_json(jdrop.to_json())
    assert back.allclose(drop) and back.to_json() == jdrop.to_json()


def test_pending_slices_raise():
    net, cfg, _, _ = _pair(0, n=10, c=2, t_max=2)
    plan = RoundPlan.connectivity_aware(net, cfg)
    with pytest.raises(NotImplementedError, match="quant"):
        plan.with_quant(object())
    with pytest.raises(NotImplementedError, match="closed-loop"):
        RoundPlan.controlled(net, cfg, "static")
    # the sparse slice has landed: CSR plans over every family
    assert RoundPlan.connectivity_aware(net, cfg, sparse=True).is_sparse
    assert len(topology.families()) == 9
    with pytest.raises(ValueError, match="unknown topology family"):
        topology.make_spec("torus", n=10, c=2)
