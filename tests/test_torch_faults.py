"""Fault models of the PyTorch port against the JAX reference.

``fl/faults.py`` is numpy in both packages, so every mask and trace must
be equal element for element for the same spec and seed, and specs and
traces must round-trip through JSON to the reference's exact text.
"""

import numpy as np
import pytest

from repro.fl import faults as jfaults
from repro_torch.fl import faults


@pytest.mark.parametrize("seed", [0, 3])
def test_availability_masks_equal_the_reference(seed):
    K, n = 6, 11
    partition = [np.arange(0, 4), np.arange(4, 9), np.arange(9, 11)]
    for name, args in (("iid_active", (K, n, 0.3)),
                       ("markov_active", (K, n, 0.2, 0.4)),
                       ("cluster_active", (K, partition, n, 0.5))):
        got = getattr(faults, name)(np.random.default_rng(seed), *args)
        want = getattr(jfaults, name)(np.random.default_rng(seed), *args)
        assert got.dtype == want.dtype and np.array_equal(got, want), name


SPECS = [
    "none",
    "iid:rate=0.2,latency=uniform,lo=0.1,hi=1.2,duplicate_rate=0.05",
    "markov:p_fail=0.2,p_recover=0.5,latency=exponential,mean=0.6",
    "cluster:rate=0.3,latency=lognormal,mu=-1.0,sigma=0.5,depart_rate=0.1",
    "none:latency=fixed,value=0.3,depart_rate=0.01",
]


@pytest.mark.parametrize("text", SPECS)
def test_traces_and_json_equal_the_reference(text):
    spec, jspec = faults.parse_fault_spec(text), jfaults.parse_fault_spec(text)
    assert spec.to_json() == jspec.to_json()
    assert faults.FaultSpec.from_json(jspec.to_json()) == spec
    partition = [np.arange(0, 5), np.arange(5, 9)]
    trace = faults.sample_trace(spec, 9, 5, seed=4, partition=partition)
    jtrace = jfaults.sample_trace(jspec, 9, 5, seed=4, partition=partition)
    assert trace.to_json() == jtrace.to_json()
    assert np.array_equal(trace.active, jtrace.active)
    assert np.array_equal(trace.arrival, jtrace.arrival)
    back = faults.FaultTrace.from_json(jtrace.to_json())
    assert back.allclose(trace)


@pytest.mark.parametrize("kind,params", [
    ("zero", None), ("fixed", {"value": 0.7}), ("uniform", {"hi": 2.0}),
    ("exponential", None), ("lognormal", {"sigma": 0.25})])
def test_draw_latency_equals_the_reference(kind, params):
    got = faults.draw_latency(np.random.default_rng(1), kind, params, (3, 4))
    want = jfaults.draw_latency(np.random.default_rng(1), kind, params,
                                (3, 4))
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("text,match", [
    ("bogus", "failures must be"), ("iid:rate=1.0", "rate"),
    ("iid:speed=1", "unknown parameter"), ("iid:rate", "malformed"),
    ("none:latency=uniform,lo=2,hi=1", "lo <= hi")])
def test_invalid_specs_raise_like_the_reference(text, match):
    with pytest.raises(ValueError, match=match):
        faults.parse_fault_spec(text)
    with pytest.raises(ValueError, match=match):
        jfaults.parse_fault_spec(text)


def test_cluster_trace_needs_a_partition():
    with pytest.raises(ValueError, match="partition"):
        faults.sample_trace(faults.FaultSpec(failures="cluster"), 4, 2)
