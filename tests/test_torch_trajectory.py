"""Parity of the port's trajectories and warm start against the JAX
package, float64 on the CPU: ``utils/trajectory.py`` (``Trajectory``,
``Solution`` and its sealing, ``resample``, the RMS comparisons, the
spline-derived columns, ``create_periodic_trajectory``),
``utils/splines.quintic_resample`` and
``Transcription.guess_from_trajectory``, and the ``Solution`` that
``Study.solve`` returns.

Problem: the hanging muscle with activation dynamics and an implicit
compliant tendon, in implicit multibody mode, so its iterate has both
kinds of derivative columns (``<coordinate>/accel`` and
``implicitderiv_normalized_tendon_force``). Trajectories are drawn with
numpy from a fixed seed, on a non-uniform time grid, with extra columns
the problem does not have and without some it has.

Held: every resampled table, guess and derived table exactly equal to
the JAX package's (the same numpy and scipy computations), but the
columns of ``generate_*``, which take the port's cubic spline on tensors
(relative 1e-12); the ``Solution`` of a CPU solve sealed exactly when it
did not converge, with the reference's derivative column names, and
taken back as a guess (``Study.solve(guess=solution)``) as
``guess_from_trajectory`` takes it.
"""

import dataclasses

import numpy as np
import pytest

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu.utils import splines as jsplines
from opensim_moco_tpu.utils import trajectory as jtraj
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.utils import splines as tsplines
from opensim_moco_tpu_torch.utils import trajectory as ttraj

FULL = dict(ignore_tendon_compliance=False, ignore_activation_dynamics=False,
            tendon_dynamics_implicit=True)


def hanging(pkg, num_mesh_intervals=6):
    """The hanging muscle in its (default) implicit multibody mode."""
    return pkg.hanging_muscle_study(num_mesh_intervals, **FULL)


def trajectories(mod, rng_seed=0, n=9, solution=False):
    """A trajectory over [0.01, 0.07] on a non-uniform grid: the problem's
    states but its speed, an extra state, its controls, and derivative
    columns of which one is not the problem's."""
    rng = np.random.default_rng(rng_seed)
    time = np.sort(np.concatenate([[0.01, 0.07],
                                   rng.uniform(0.01, 0.07, n - 2)]))
    states = ["/jointset/joint/height/value", "/forceset/muscle/activation",
              "/forceset/muscle/normalized_tendon_force", "/extra/state"]
    controls = ["/forceset/muscle", "/forceset/unknown"]
    derivs = ["/jointset/joint/height/accel",
              "/forceset/muscle/implicitderiv_normalized_tendon_force",
              "/forceset/other/implicitderiv_normalized_tendon_force"]
    cls = mod.Solution if solution else mod.Trajectory
    return cls(time=time, state_names=states,
               states=rng.normal(size=(n, len(states))),
               control_names=controls,
               controls=rng.uniform(0, 1, (n, len(controls))),
               derivative_names=derivs,
               derivatives=rng.normal(size=(n, len(derivs))))


def _tables_equal(a, b):
    for name in ("time", "states", "controls", "multipliers",
                 "derivatives"):
        x, y = getattr(a, name), getattr(b, name)
        if y is None:
            assert x is None, name
        else:
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert a.state_names == b.state_names
    assert a.control_names == b.control_names
    assert a.derivative_names == b.derivative_names


@pytest.mark.parametrize("n", [4, 9])
def test_resample_matches_jax(n):
    a, b = trajectories(ttraj, n=n), trajectories(jtraj, n=n)
    new = np.concatenate([np.linspace(0.0, 0.08, 23), a.time[2:4]])
    for method in ("quintic", "linear"):
        _tables_equal(a.resample(new, method), b.resample(new, method))
    np.testing.assert_array_equal(
        tsplines.quintic_resample(a.time, a.states, new),
        jsplines.quintic_resample(b.time, b.states, new))
    # a repeated time makes the quintic fall back to linear, in both
    dup = dataclasses.replace(a, time=np.r_[a.time[:3], a.time[2:-1]])
    dup_j = dataclasses.replace(b, time=dup.time)
    _tables_equal(dup.resample(new), dup_j.resample(new))


def test_trajectory_utilities_match_jax():
    a, b = trajectories(ttraj), trajectories(jtraj)
    a2, b2 = trajectories(ttraj, 1), trajectories(jtraj, 1)
    assert a.compare_states_rms(a2) == b.compare_states_rms(b2)
    assert a.compare_controls_rms(a2) == b.compare_controls_rms(b2)
    _tables_equal(a.randomize_add(0.1, 3), b.randomize_add(0.1, 3))
    assert a.is_compatible(["/extra/state"], []) == \
        b.is_compatible(["/extra/state"], [])
    assert a.is_compatible(["/no"], ["/forceset/muscle"],
                           require_all=True) is False
    assert a.is_numerically_equal(a) and not a.is_numerically_equal(a2)
    names = a.state_names[:2] + ["/jointset/j_r/q_r/value",
                                 "/jointset/j_l/q_l/value"]
    per_a = dataclasses.replace(a, state_names=names)
    per_b = dataclasses.replace(b, state_names=names)
    _tables_equal(ttraj.create_periodic_trajectory(per_a),
                  jtraj.create_periodic_trajectory(per_b))
    speeds = ["/jointset/joint/height/value", "/jointset/joint/height/speed",
              "/a/value", "/a/speed"]
    sp_a = dataclasses.replace(a, state_names=speeds)
    sp_b = dataclasses.replace(b, state_names=speeds)
    for fn in ("generate_speeds_from_values",
               "generate_accelerations_from_speeds",
               "generate_accelerations_from_values"):
        got, ref = getattr(sp_a, fn)(), getattr(sp_b, fn)()
        assert got.derivative_names == ref.derivative_names
        for name in ("states", "derivatives"):
            x, y = getattr(got, name), np.asarray(getattr(ref, name))
            np.testing.assert_allclose(x, y, rtol=0,
                                       atol=1e-12 * np.abs(y).max())


def test_solution_sealing():
    for mod in (ttraj, jtraj):
        sol = trajectories(mod, solution=True)
        assert not sol.sealed
        sol.seal()
        with pytest.raises(mod.SealedSolutionError):
            sol.state("/extra/state")
        with pytest.raises(mod.SealedSolutionError):
            sol.control("/forceset/muscle")
        np.testing.assert_array_equal(sol.unseal().state("/extra/state"),
                                      sol.states[:, 3])
    assert issubclass(ttraj.SealedSolutionError, RuntimeError)


def test_guess_from_trajectory_matches_jax():
    trj = hanging(jex).transcription()
    trt = hanging(tex).transcription()
    assert trt.nderiv == trj.nderiv == 2
    assert trt.derivative_names() == [
        "/jointset/joint/height/accel",
        "/forceset/muscle/implicitderiv_normalized_tendon_force"]
    for n in (4, 9):
        got = trt.guess_from_trajectory(trajectories(ttraj, n=n))
        ref = trj.guess_from_trajectory(trajectories(jtraj, n=n))
        np.testing.assert_array_equal(got, np.asarray(ref))
    # the derivative block was copied in by name
    D = got[trt.offsets["derivs"][0]:trt.offsets["derivs"][1]]
    assert np.any(D != trt.initial_guess()[trt.offsets["derivs"][0]:
                                           trt.offsets["derivs"][1]])


def test_study_solution_sealed_and_taken_back():
    """``Study.solve`` returns a ``Solution``, sealed when the solve did not
    converge; a converged one is a guess for the next solve."""
    study = tex.sliding_mass_study(10)
    sol = study.solve("cpu")
    assert isinstance(sol, ttraj.Solution)
    assert sol.success and not sol.sealed, sol.status
    tr = study.transcription()
    np.testing.assert_array_equal(
        study.solve("cpu", guess=sol).raw_iterate,
        study.solve("cpu", guess=tr.guess_from_trajectory(sol)).raw_iterate)
    study.set_ipm_options(max_iter=2)
    stalled = study.solve("cpu")
    assert not stalled.success and stalled.sealed
    with pytest.raises(ttraj.SealedSolutionError):
        stalled.state("/jointset/slider/position/value")
    np.testing.assert_array_equal(
        stalled.unseal().state("/jointset/slider/position/value"),
        stalled.states[:, 0])


def test_study_expand_derivative_columns():
    """``Study.expand`` names the derivative columns as the reference does
    and takes them from the iterate; the result goes back through
    ``guess_from_trajectory`` to the same iterate."""
    study = hanging(tex)
    tr = study.transcription()
    z = tr.initial_guess() + np.random.default_rng(2).uniform(
        -0.01, 0.01, tr.n)
    sol = study.expand(tr, z, 1.0, 0.5, 7, False)
    assert sol.sealed and sol.num_iterations == 7
    assert sol.derivative_names == tr.derivative_names()
    D = z[tr.offsets["derivs"][0]:tr.offsets["derivs"][1]]
    np.testing.assert_array_equal(sol.derivatives.ravel(), D)
    back = tr.guess_from_trajectory(sol.unseal())
    np.testing.assert_allclose(back[2:], z[2:], rtol=0, atol=1e-12)
