"""Every topology family of the PyTorch port against the JAX reference.

The families are numpy in both packages and must consume a seeded
``default_rng`` in the same order, so the snapshots are bitwise equal:
``sample`` (dense blocks) and ``sample_sparse`` (CSR blocks), over
consecutive rounds (the time-correlated families carry state), with and
without self-loops and under periodic re-clustering.  Plans built over
each family -- dense and sparse, through the markov / cluster / fault
transforms -- must serialize to the same ``to_json()`` text.
"""

import numpy as np
import pytest

from repro import topology as jtopology
from repro.core.server import ServerConfig as JServerConfig
from repro.fl.faults import FaultSpec as JFaultSpec
from repro.fl.faults import sample_trace as jsample_trace
from repro.fl.plan import RoundPlan as JRoundPlan
from repro.topology import MeasuredTrace as JMeasuredTrace
from repro_torch import topology
from repro_torch.core.server import ServerConfig
from repro_torch.fl.faults import FaultSpec, sample_trace
from repro_torch.fl.plan import RoundPlan
from repro_torch.topology import MeasuredTrace

FAMILIES = topology.families()


def _both(family, **kw):
    return (topology.make_spec(family, **kw).build(),
            jtopology.make_spec(family, **kw).build())


def _same_snapshot(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.vertices, b.vertices)
        for name in ("indptr", "indices", "W"):
            if hasattr(b, name):
                x, y = getattr(a, name), getattr(b, name)
                assert x.dtype == y.dtype and np.array_equal(x, y), name


def test_every_reference_family_is_registered():
    assert FAMILIES == jtopology.families()
    assert len(FAMILIES) == 9
    for family in FAMILIES:
        assert topology.family_defaults(family) == \
            jtopology.family_defaults(family)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("seed", [0, 5])
def test_snapshots_are_bitwise_the_reference(family, seed):
    # one model per representation: the time-correlated families carry
    # state from round to round
    model, jmodel = _both(family, n=24, c=3)
    smodel, jsmodel = _both(family, n=24, c=3)
    rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
    srng, jsrng = np.random.default_rng(seed), np.random.default_rng(seed)
    for t in range(4):
        _same_snapshot(model.sample(rng, t), jmodel.sample(jrng, t))
        _same_snapshot(smodel.sample_sparse(srng, t),
                       jsmodel.sample_sparse(jsrng, t))
    # the generators were advanced identically
    assert rng.random() == jrng.random() and srng.random() == jsrng.random()


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("variant", [
    dict(self_loops=False), dict(membership="skewed"),
    dict(membership_params={"recluster_every": 2})])
def test_snapshot_variants_are_bitwise_the_reference(family, variant):
    model, jmodel = _both(family, n=21, c=3, **variant)
    rng, jrng = np.random.default_rng(3), np.random.default_rng(3)
    for t in range(4):
        _same_snapshot(model.sample_sparse(rng, t),
                       jmodel.sample_sparse(jrng, t))


def test_learned_family_follows_pushed_similarity():
    model, jmodel = _both("learned", n=12, c=2, k=2)
    S = np.random.default_rng(0).random((12, 12))
    rng, jrng = np.random.default_rng(1), np.random.default_rng(1)
    _same_snapshot(model.sample(rng, 0), jmodel.sample(jrng, 0))
    model.set_similarity(S)
    jmodel.set_similarity(S)
    _same_snapshot(model.sample(rng, 1), jmodel.sample(jrng, 1))
    with pytest.raises(ValueError, match="similarity"):
        model.set_similarity(S[:5])


@pytest.mark.parametrize("sparse", [False, True])
def test_measured_trace_from_plan_matches_reference(sparse):
    model, jmodel = _both("geometric", n=12, c=2)
    cfg = dict(T=2, t_max=3, m0=4, seed=2)
    plan = RoundPlan.connectivity_aware(model, ServerConfig(**cfg),
                                        sparse=sparse)
    jplan = JRoundPlan.connectivity_aware(jmodel, JServerConfig(**cfg),
                                          sparse=sparse)
    spec = MeasuredTrace.from_plan(plan)
    assert spec.to_json() == JMeasuredTrace.from_plan(jplan).to_json()
    # the replayed trace rebuilds the plan's mixing matrices
    replay = RoundPlan.connectivity_aware(spec.build(), ServerConfig(**cfg))
    A = plan.A_t.dense() if sparse else plan.A_t
    np.testing.assert_array_equal(replay.A_t, A)


@pytest.mark.parametrize("text", [
    "ring:hops=2", "hub:hubs=2,recluster_every=3",
    "k_regular:k_range=6-9,p_fail=0.2",
    "geometric:radius=0.3,membership=skewed,gamma=0.6"])
def test_parse_spec_matches_reference(text):
    spec = topology.parse_spec(text, n=40, c=4)
    assert spec.to_json() == jtopology.parse_spec(text, n=40, c=4).to_json()
    assert topology.from_json(spec.to_json()).spec == spec


def _plans(family, dropout, sparse, n=18, c=3, K=3, seed=9):
    """(port, reference) plans: the same spec, seed, dropout transform
    and fault trace (the reference's parity sweep, tests/
    test_sparse_parity.py)."""
    out = []
    for top, Cfg, Plan, Spec, trace_of in (
            (topology, ServerConfig, RoundPlan, FaultSpec, sample_trace),
            (jtopology, JServerConfig, JRoundPlan, JFaultSpec,
             jsample_trace)):
        cfg = Cfg(T=2, t_max=K, m0=max(2, n // 3), seed=seed)
        plan = Plan.connectivity_aware(top.make_spec(family, n=n, c=c)
                                       .build(), cfg, sparse=sparse)
        rng = np.random.default_rng(seed + 1)
        if dropout == "iid":
            plan = plan.with_dropout(0.25, rng)
        elif dropout == "markov":
            plan = plan.with_markov_dropout(0.3, 0.5, rng)
        else:
            plan = plan.with_cluster_dropout(0.3, rng)
        trace = trace_of(Spec(failures="iid", failure_params={"rate": 0.2}),
                         n=n, K=K, seed=seed + 2)
        out.append(plan.with_faults(trace))
    return out


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("sparse", [False, True])
def test_plans_with_transforms_are_byte_identical(family, sparse):
    for dropout in ("iid", "markov", "cluster"):
        plan, jplan = _plans(family, dropout, sparse)
        assert plan.is_sparse == sparse
        assert plan.to_json() == jplan.to_json(), dropout
        assert np.array_equal(plan.active_t, jplan.active_t)
        assert np.array_equal(plan.arrival_t, jplan.arrival_t)
        back = RoundPlan.from_json(jplan.to_json())
        assert back.allclose(plan) and back.to_json() == plan.to_json()


@pytest.mark.parametrize("family", ["geometric", "preferential_attachment",
                                    "ring"])
def test_sparse_regenerate_is_byte_identical(family):
    model, jmodel = _both(family, n=20, c=4)
    cfg = dict(T=2, t_max=4, m0=6, seed=13)
    plan = RoundPlan.connectivity_aware(model, ServerConfig(**cfg),
                                        sparse=True)
    jplan = JRoundPlan.connectivity_aware(jmodel, JServerConfig(**cfg),
                                          sparse=True)
    regen = plan.with_markov_dropout(0.2, 0.5).regenerate()
    assert regen.is_sparse
    assert regen.to_json() == \
        jplan.with_markov_dropout(0.2, 0.5).regenerate().to_json()
    assert regen.allclose(plan.with_markov_dropout(0.2, 0.5))
