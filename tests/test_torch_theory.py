"""``repro_torch.core.theory`` (a numpy-only copy) against the reference's
``repro.core.theory``: the t1 threshold, the step-size schedule and the
eq.-(9) gap envelope must be bitwise equal, scalar and ndarray alike --
the same IEEE operations in the same order on both sides."""

import numpy as np
import pytest

from repro.core import theory as jtheory
from repro_torch.core import theory

CONSTANTS = [dict(mu=0.1, beta=1.0, rho=0.5, delta=0.2, gamma=0.3, n=70,
                  T=5),
             dict(mu=0.7, beta=2.5, rho=0.0, delta=1.3, gamma=0.0, n=6,
                  T=1),
             dict(mu=1e-3, beta=0.05, rho=2.0, delta=0.01, gamma=4.0,
                  n=100_000, T=20)]


@pytest.mark.parametrize("kw", CONSTANTS)
@pytest.mark.parametrize("phi_max", [0.0, 0.06, 1.7])
def test_theory_matches_reference_bitwise(kw, phi_max):
    c, jc = theory.TheoryConstants(**kw), jtheory.TheoryConstants(**kw)
    t1 = theory.t1_threshold(c, phi_max)
    assert t1 == jtheory.t1_threshold(jc, phi_max) and type(t1) is int
    eta, jeta = theory.eta_schedule(c, phi_max), \
        jtheory.eta_schedule(jc, phi_max)
    for t in (0, 1, 7, 10_000):
        got = eta(t)
        assert type(got) is float and got == jeta(t)
    ts = np.arange(0, 50, 3)
    np.testing.assert_array_equal(eta(ts), jeta(ts))
    np.testing.assert_array_equal(eta(ts)[2], eta(int(ts[2])))
    for t in (ts, 0, 12.5):
        np.testing.assert_array_equal(
            theory.gap_bound(c, phi_max, 3.0, t),
            jtheory.gap_bound(jc, phi_max, 3.0, t))


def test_gap_bound_decays_from_gap0():
    c = theory.TheoryConstants(mu=0.5, beta=1.0, rho=0.0, delta=0.0,
                               gamma=0.0, n=10, T=2)
    g = theory.gap_bound(c, 0.1, 2.0, np.arange(100))
    assert g[0] == 2.0 and (np.diff(g) < 0).all()
