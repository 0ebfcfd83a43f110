"""Parity of the port's ``Study.create_guess`` and
``Problem.set_state_info_pattern`` against the JAX package, float64 on the
CPU.

``create_guess`` on ``hanging_muscle_study(10)`` (activation dynamics, a
rigid tendon): the bounds and random guesses (seeds 0 and 3: the same
numpy calls) exactly equal to the JAX package's; the time-stepping guess
(an RK4 rollout clipped into the state bounds) within 1e-10 of its
largest magnitude, with the JAX test's own assertions (states moved off
the midpoint, inside the bounds, finite).

``set_state_info_pattern`` on the double pendulum's model, a ``Problem``
given its model by ``set_model``: patterns that overlap each other (the
first set wins) and an explicit info (which wins over every pattern);
``ProblemRep``'s bound arrays exactly equal to the JAX package's.
"""

import numpy as np
import pytest

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu import ocp as jocp
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch import ocp as tocp
from test_torch_constrained_common import one_blas_thread

BOUND_ARRAYS = ("y_lo", "y_hi", "y0_lo", "y0_hi", "yf_lo", "yf_hi", "x_lo",
                "x_hi", "x0_lo", "x0_hi", "xf_lo", "xf_hi")


def test_create_guess_matches_jax():
    sj, st = jex.hanging_muscle_study(10), tex.hanging_muscle_study(10)
    assert st.update_problem() is st.problem
    for kind, seed in (("bounds", 0), ("random", 0), ("random", 3)):
        np.testing.assert_array_equal(
            st.create_guess(kind, seed=seed, device="cpu"),
            np.asarray(sj.create_guess(kind, seed=seed)))
    with one_blas_thread():
        ref = np.asarray(sj.create_guess("time-stepping"))
    got = st.create_guess("time-stepping", device="cpu")
    assert np.abs(got - ref).max() <= 1e-10 * np.abs(ref).max()
    tr = st.transcription()
    zb = st.create_guess("bounds", device="cpu")
    lb, ub = tr.bounds()
    o = slice(*tr.offsets["states"])
    assert not np.allclose(got[o], zb[o])
    assert np.all(got[o] >= lb[o]) and np.all(got[o] <= ub[o])
    assert np.isfinite(got).all()
    assert not np.allclose(st.create_guess("random", seed=3, device="cpu"),
                           zb)
    with pytest.raises(NotImplementedError):
        st.create_guess("other", device="cpu")


def test_state_info_patterns_match_jax():
    reps = []
    for ex, ocp in ((jex, jocp), (tex, tocp)):
        pr = ocp.Problem()
        pr.set_model(ex.double_pendulum_swingup_study(4).problem.model)
        pr.set_time_bounds(0, 1)
        pr.set_state_info_pattern(r".*/speed", (-7, 7), initial=0)
        pr.set_state_info_pattern(r"/jointset/j0/.*", (-3, 3),
                                  final=(1.0, 2.0))
        pr.set_state_info_pattern(r"/jointset/j1/.*/value", (-4, 4),
                                  initial=(-1, 1), final=0.5)
        pr.set_state_info_pattern(r"j1", (-9, 9))  # fullmatch: no state
        pr.set_state_info("/jointset/j1/q1/value", (-2, 2), 0.25)
        reps.append(pr.create_rep())
    rj, rt = reps
    for name in BOUND_ARRAYS:
        np.testing.assert_array_equal(getattr(rt, name), getattr(rj, name),
                                      err_msg=name)
    # the j0 speed takes the first pattern it matches, q1 its explicit info
    i = rt.state_index("/jointset/j0/q0/speed")
    assert (rt.y_lo[i], rt.y0_hi[i], rt.yf_lo[i]) == (-7, 0, -7)
    i = rt.state_index("/jointset/j1/q1/value")
    assert (rt.y_lo[i], rt.y0_lo[i], rt.yf_hi[i]) == (-2, 0.25, 2)
