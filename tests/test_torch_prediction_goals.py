"""Parity of the port's prediction goals against the JAX package, float64
on the CPU: ``AverageSpeedGoal`` (a coordinate's speed and, with
``use_com``, the center of mass's) as an endpoint constraint and as a
cost, and ``ControlGoal(divide_by_displacement=True)`` (cubed effort over
the center of mass's displacement), as gait2d's predictive problem poses
them.

Model: a cart on a slider (x) carrying a pendulum (theta), actuated on
both coordinates; a free final time in [0.8, 1.2]; Hermite-Simpson at
mesh 4.

Held, for each of four goal combinations: the layout and bounds
(exactly); c(z) and f(z) at the bounds-midpoint guess and a jittered
point (relative 1e-12); finite gradients of f and Jacobian-vector
products of c in both packages at the cold bounds-midpoint guess, whose
displacement is zero (the smoothed norm); ``kkt_structure()`` None in
the port exactly where it is None in the JAX package, and otherwise the
same index lists. For the predictive combination (the center of mass's
speed as a constraint, the effort over its displacement), on the dense
KKT path, ``init_fn`` and three chained ``body_fn`` steps from 4
jittered starts within 1e-6 of the JAX package's per lane, mu and the
counters exactly (``test_torch_constrained_common.check_iterate_parity``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu import ocp as jocp
from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu_torch import ocp as tocp
from opensim_moco_tpu_torch.models import MechModelBuilder as TMechModelBuilder
from opensim_moco_tpu_torch.models.model import Model as TModel
from test_torch_constrained_common import (check_functions,
                                           check_iterate_parity, check_layout,
                                           check_structure)

torch.set_num_threads(2)

JAX = (JMechModelBuilder, JModel, jocp)
PORT = (TMechModelBuilder, TModel, tocp)
ITERATE_RTOL = 1e-6
# (speed measure, speed goal's mode, effort over displacement)
CASES = {
    "com_constraint_per_distance": ("com", "endpoint_constraint", True),
    "coord_constraint": ("coord", "endpoint_constraint", False),
    "com_cost": ("com", "cost", False),
    "coord_cost_per_distance": ("coord", "cost", True),
}
DENSE = dict(tol=1e-8, max_iter=50, mu_init=1e-2, kkt="dense",
             hessian_approximation="objective-only")


def cart_pendulum(pkg):
    B, Model = pkg[:2]
    b = B(gravity=(0.0, -9.81, 0.0))
    b.add_body("cart", mass=2.0, com=(0.0, 0.05, 0.0),
               inertia=np.diag([0.01, 0.01, 0.01]), joint_name="slider",
               kind="prismatic", axis=(1, 0, 0), coord_name="x")
    b.add_body("pole", mass=0.8, com=(0.0, -0.4, 0.0),
               inertia=np.diag([0.02, 0.002, 0.02]), parent="cart",
               joint_name="hinge", kind="revolute", axis=(0, 0, 1),
               coord_name="theta")
    model = Model(b.finalize())
    model.add_coordinate_actuator("fx", "x", optimal_force=10.0,
                                  min_control=-5, max_control=5)
    model.add_coordinate_actuator("tau", "theta", optimal_force=5.0,
                                  min_control=-5, max_control=5)
    return model.finalize()


def problem(pkg, case):
    ocp = pkg[2]
    speed, mode, per_distance = CASES[case]
    prob = ocp.Problem(cart_pendulum(pkg))
    prob.set_time_bounds(0.0, (0.8, 1.2))
    prob.set_state_info("/jointset/slider/x/value", (-1.0, 2.0))
    prob.set_state_info("/jointset/slider/x/speed", (-5.0, 5.0))
    prob.set_state_info("/jointset/hinge/theta/value", (-1.0, 1.0))
    prob.set_state_info("/jointset/hinge/theta/speed", (-8.0, 8.0))
    prob.add_goal(ocp.AverageSpeedGoal(name="speed", mode=mode, weight=5.0,
                                       use_com=speed == "com",
                                       desired_speed=0.9))
    prob.add_goal(ocp.ControlGoal(name="effort", exponent=3,
                                  divide_by_displacement=per_distance))
    study = ocp.Study(prob)
    study.set_solver_options(num_mesh_intervals=4)
    return study.transcription()


@pytest.mark.parametrize("case", sorted(CASES))
def test_prediction_goals_functions_and_structure(case):
    trj, trt = problem(JAX, case), problem(PORT, case)
    check_layout(trj, trt)
    check_functions(trj, trt)
    nj, nt = trj.make_nlp(), trt.make_nlp("cpu")
    # the cold guess: the same q at both ends, no displacement
    z0 = trt.initial_guess()
    Y = z0[trt.offsets["states"][0]:trt.offsets["states"][1]].reshape(
        trt.G, trt.ny)
    np.testing.assert_array_equal(Y[0, :2], Y[-1, :2])
    ones = np.ones_like(z0)
    g_j = jax.grad(nj.objective)(jnp.asarray(z0))
    jv_j = jax.jvp(nj.constraints, (jnp.asarray(z0),),
                   (jnp.asarray(ones),))[1]
    g_t = torch.func.grad(nt.objective)(torch.as_tensor(z0))
    jv_t = torch.func.jvp(nt.constraints, (torch.as_tensor(z0),),
                          (torch.as_tensor(ones),))[1]
    for a in (np.asarray(g_j), np.asarray(jv_j), g_t.numpy(), jv_t.numpy()):
        assert np.isfinite(a).all()
    _, mode, per_distance = CASES[case]
    assert (trt.kkt_structure() is None) == (trj.kkt_structure() is None)
    assert (trt.kkt_structure() is None) == (mode == "cost" or per_distance)
    if trt.kkt_structure() is not None:
        check_structure(trj, trt)
    names = [n for n, _ in trt.constraint_group_info()]
    assert ("endpoint:speed" in names) == (mode == "endpoint_constraint")


def test_prediction_goals_dense_iterate_parity():
    """The predictive form: the center of mass's speed held, the effort
    over its displacement."""
    case = "com_constraint_per_distance"
    check_iterate_parity(problem(JAX, case), problem(PORT, case), DENSE,
                         ITERATE_RTOL)
