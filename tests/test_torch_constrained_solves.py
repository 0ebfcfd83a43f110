"""Constrained problems solved end to end by the port's ``Study.solve`` on
the CPU, against their analytic answers (the JAX package's
``test_sliding_mass.py``, ``test_constraints.py`` and
``test_parameters.py`` problems, at mesh 10).

Kirk's minimum-effort problem (a negative damper: the generalized
spring): states within 5e-4 of Kirk's closed form. Hermite-Simpson at 10
intervals carries a discretization error of 1.5e-4 there (at 50
intervals, the JAX test's mesh, it is 3e-7 and the JAX test holds 1e-5).

The oscillator mass (an optimizable parameter): m within 1e-3 of 1, as
the JAX test holds it, in both goal modes (m = 0.99997 at mesh 10), and
q(t) within 1e-4 of cos(t) (up to 3e-5 at mesh 10; the JAX test holds
2e-3 at mesh 40).
"""

import numpy as np
import pytest
import torch

from opensim_moco_tpu_torch import examples as tex

torch.set_num_threads(2)


def kirk_expected(time):
    """Kirk 1998 eq. 5.1-69/70 (a copy of the JAX package's test
    helper)."""
    e = np.exp
    A = np.array([
        [-2 - 0.5 * e(-2) + 0.5 * e(2), 1 - 0.5 * e(-2) - 0.5 * e(2)],
        [-1 + 0.5 * e(-2) + 0.5 * e(2), 0.5 * e(-2) - 0.5 * e(2)],
    ])
    c2, c3 = np.linalg.solve(A, np.array([5.0, 2.0]))
    x0 = c2 * (-time - 0.5 * e(-time) + 0.5 * e(time)) + \
        c3 * (1 - 0.5 * e(-time) - 0.5 * e(time))
    x1 = c2 * (-1 + 0.5 * e(-time) + 0.5 * e(time)) + \
        c3 * (0.5 * e(-time) - 0.5 * e(time))
    return np.stack([x0, x1], axis=1)


def test_kirk_min_effort_analytic():
    study = tex.kirk_min_effort_study(10)
    study.set_ipm_options(tol=1e-7, max_iter=300)
    sol = study.solve("cpu")
    assert sol.success, sol.status
    np.testing.assert_allclose(sol.states[:, :2], kirk_expected(sol.time),
                               rtol=0, atol=5e-4)


def test_swingup_with_path_constraint():
    """The double-pendulum swing-up with its elbow path constraint
    (``test_examples.py::test_double_pendulum_swingup``'s endpoint checks,
    at mesh 10): hanging at t=0, inverted at t=1, elbow in [-2, 2] at the
    mesh points, where the constraint holds (the Hermite-Simpson
    midpoints may pass it: 2.02 in the JAX package's solution too)."""
    study = tex.double_pendulum_swingup_study(10, with_path_constraint=True)
    study.set_ipm_options(tol=1e-6, max_iter=300)
    sol = study.solve("cpu")
    assert sol.success, sol.status
    q0 = sol.state("/jointset/j0/q0/value")
    q1 = sol.state("/jointset/j1/q1/value")
    assert abs(q0[0]) < 1e-6
    assert abs(q0[-1] - np.pi) < 1e-6
    assert abs(q1[-1]) < 1e-6
    assert np.all(np.abs(q1[::2]) <= 2.0 + 1e-6)
    assert np.abs(q1).max() > 1.9  # the constraint is active


@pytest.mark.parametrize("goal_mode,kkt", [("cost", "auto"),
                                           ("endpoint_constraint",
                                            "structured")])
def test_oscillator_mass(goal_mode, kkt):
    study = tex.oscillator_mass_study(10, goal_mode)
    study.set_ipm_options(kkt=kkt)
    tr = study.transcription()
    assert (tr.kkt_structure() is None) == (goal_mode == "cost")
    sol = study.solve("cpu")
    assert sol.success, sol.status
    assert sol.parameter_names == ["osc_mass"]
    assert abs(float(sol.parameters[0]) - 1.0) < 1e-3
    np.testing.assert_allclose(sol.state("/jointset/j/q/value"),
                               np.cos(sol.time), rtol=0, atol=1e-4)


def test_coupler_pendulum():
    """``test_constraints.py::test_coupler_constrained_double_pendulum``'s
    checks at mesh 10, under ``kkt="structured"`` (the multipliers and
    velocity corrections in the blocks)."""
    study = tex.coupler_pendulum_study(10)
    study.set_ipm_options(kkt="structured")
    sol = study.solve("cpu")
    assert sol.success, sol.status
    q0 = sol.state("/jointset/j0/q0/value")
    q1 = sol.state("/jointset/j1/q1/value")
    np.testing.assert_allclose(q1, q0, rtol=0, atol=1e-6)
    assert abs(q0[-1] - 0.6) < 1e-6
    np.testing.assert_allclose(sol.state("/jointset/j1/q1/speed"),
                               sol.state("/jointset/j0/q0/speed"), rtol=0,
                               atol=1e-5)
    assert sol.multipliers.shape == (len(sol.time), 1)
    assert np.all(np.isfinite(sol.multipliers))
