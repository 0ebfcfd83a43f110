"""Kinematic constraints in the transcription, the port against the JAX
package: the coupler-constrained double pendulum of the JAX package's
``test_constraints.py`` (mesh 6) under both schemes, with and without
``enforce_constraint_derivatives``, and once in implicit multibody mode
with ``minimize_lagrange_multipliers``. Layout (multipliers, the
Hermite-Simpson velocity corrections), bounds, guess, c(z), f(z), the KKT
structure's index lists and the compressed derivative blocks (the
constraint Jacobian is a forward-mode derivative nested in the seeded
tangents there). Checks and tolerances in
``test_torch_constrained_common.py``."""

import logging

import numpy as np
import pytest

from opensim_moco_tpu.models import MechModelBuilder
from opensim_moco_tpu.models.model import Model
from opensim_moco_tpu.ocp import ControlGoal, Problem, Study
from opensim_moco_tpu_torch import examples as tex
from test_torch_constrained_common import (check_blocks, check_functions,
                                           check_layout, check_structure)


def jax_coupler(mesh, scheme, enforce):
    """The JAX package's coupler pendulum (test_constraints.py:60)."""
    b = MechModelBuilder(gravity=(0, -9.81, 0))
    b.add_body("link1", mass=1.0, com=(0, -0.5, 0),
               inertia=np.diag([0, 0, 1.0 / 12]), joint_name="j0",
               kind="revolute", axis=(0, 0, 1), coord_name="q0")
    b.add_body("link2", mass=1.0, com=(0, -0.5, 0), parent="link1",
               joint_name="j1", kind="revolute", axis=(0, 0, 1),
               tree_r=(0, -1.0, 0), coord_name="q1")
    model = Model(b.finalize())
    model.add_coordinate_actuator("tau0", "q0", optimal_force=1.0,
                                  min_control=-100, max_control=100)
    model.add_coordinate_actuator("tau1", "q1", optimal_force=1.0,
                                  min_control=-100, max_control=100)
    model.add_kinematic_constraint("coupler", lambda mp, q: q[1:2] - q[0:1])
    model.finalize()
    prob = Problem(model)
    prob.set_time_bounds(0, 1)
    prob.set_state_info("/jointset/j0/q0/value", (-5, 5), 0, 0.6)
    prob.set_state_info("/jointset/j1/q1/value", (-5, 5), 0)
    prob.set_state_info("/jointset/j0/q0/speed", (-20, 20), 0, 0)
    prob.set_state_info("/jointset/j1/q1/speed", (-20, 20), 0)
    prob.add_goal(ControlGoal(name="effort", weight=0.5))
    study = Study(prob)
    study.set_solver_options(transcription_scheme=scheme,
                             num_mesh_intervals=mesh,
                             enforce_constraint_derivatives=enforce)
    return study


CASES = {
    "hs_derivs": ("hermite-simpson", True, {}),
    "hs_no_derivs": ("hermite-simpson", False, {}),
    "trapezoidal_derivs": ("trapezoidal", True, {}),
    "trapezoidal_no_derivs": ("trapezoidal", False, {}),
    "hs_implicit_min_multipliers": ("hermite-simpson", True, dict(
        multibody_dynamics_mode="implicit",
        minimize_lagrange_multipliers=True, lagrange_multiplier_weight=0.3)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    scheme, enforce, extra = CASES[request.param]
    sj = jax_coupler(6, scheme, enforce)
    st = tex.coupler_pendulum_study(6, scheme, enforce)
    sj.set_solver_options(**extra)
    st.set_solver_options(**extra)
    return sj.transcription(), st.transcription()


def test_layout_bounds_guess(pair):
    check_layout(*pair)
    trj, trt = pair
    assert trt.nlam == 1
    assert trt.n_gamma == (1 if trt.hermite_simpson and
                           trt.opt.enforce_constraint_derivatives else 0)


def test_constraints_objective(pair):
    check_functions(*pair)


def test_kkt_structure(pair):
    check_structure(*pair)


def test_block_derivatives(pair):
    check_blocks(*pair)


def test_rank_warning_without_derivatives(caplog):
    """Two copies of the same constraint without derivative enforcement:
    a rank-deficient G, so the solve logs the JAX package's warning."""
    study = tex.coupler_pendulum_study(4, enforce_constraint_derivatives=False)
    study.problem.model.add_kinematic_constraint(
        "again", lambda mp, q: q[..., 1:2] - q[..., 0:1])
    study.problem.model.finalize()
    study.set_ipm_options(max_iter=1)
    with caplog.at_level(logging.WARNING, "opensim_moco_tpu_torch"):
        sol = study.solve("cpu")
    assert sol.multipliers.shape == (9, 2)
    assert sol.multiplier_names == ["lambda_cid0_p0", "lambda_cid1_p0"]
    assert "Rank-deficient constraint Jacobian detected." in caplog.text
