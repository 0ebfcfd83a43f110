"""Optimizable parameters and ``CustomGoal`` in the port against the JAX
package: the oscillator-mass problem of the JAX package's
``test_parameters.py`` (mesh 6), with its custom cost (dense path: no KKT
structure on either side) and in ``examples.oscillator_mass_study``'s
structured form (a tracking integrand, and the initial rest as a custom
endpoint-constraint row: the parameter and the row form the border). The JAX package's ``CustomGoal`` has no endpoint-constraint
mode; the test gives its JAX twin the ``values`` the port's has. Checks
and tolerances in ``test_torch_constrained_common.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu.models import MechModelBuilder
from opensim_moco_tpu.models.model import Model
from opensim_moco_tpu.ocp import CustomGoal, Problem, Study
from opensim_moco_tpu_torch import examples as tex
from test_torch_constrained_common import (check_blocks, check_functions,
                                           check_layout, check_structure)


class _EndpointCustomGoal(CustomGoal):
    def values(self, rep, initial, final, p):
        return jnp.atleast_1d(self.value_fn(rep, initial, final, None, p))


def jax_oscillator(mesh, goal_mode):
    """The JAX twin of ``examples.oscillator_mass_study``."""
    b = MechModelBuilder(gravity=(0.0, 0.0, 0.0))
    b.add_body("osc", mass=3.0, joint_name="j", kind="prismatic",
               axis=(1, 0, 0), coord_name="q")
    model = Model(b.finalize())
    model.add_spring_generalized_force("spring", "q", stiffness=1.0)
    model.finalize()
    prob = Problem(model)
    prob.set_time_bounds(0, np.pi)
    prob.set_state_info("/jointset/j/q/value", (-5, 5), 1.0)

    def apply_mass(p, theta):
        mech = dict(p["mech"])
        mech["mass"] = mech["mass"].at[0].set(theta)
        return {**p, "mech": mech}

    if goal_mode == "cost":
        prob.set_state_info("/jointset/j/q/speed", (-5, 5), 0.0)
        prob.add_parameter("osc_mass", (0.1, 10.0), apply_mass,
                           initial_value=3.0)
        prob.add_goal(CustomGoal(
            name="endpoint_match",
            value_fn=lambda rep, initial, final, integral, p:
            (final[1][0] + 1.0) ** 2 + final[1][1] ** 2))
    else:
        prob.set_state_info("/jointset/j/q/speed", (-5, 5))
        prob.add_parameter("osc_mass", (0.5, 2.0), apply_mass,
                           initial_value=3.0)
        prob.add_goal(CustomGoal(
            name="track", integrand_fn=lambda rep, t, y, x, lam, p:
            (y[0] - jnp.cos(t)) ** 2))
        prob.add_goal(_EndpointCustomGoal(
            name="initial_rest", mode="endpoint_constraint",
            value_fn=lambda rep, initial, final, integral, p:
            initial[1][1]))
    study = Study(prob)
    study.set_solver_options(num_mesh_intervals=mesh)
    return study


@pytest.fixture(scope="module", params=["cost", "endpoint_constraint"])
def pair(request):
    return (jax_oscillator(6, request.param).transcription(),
            tex.oscillator_mass_study(6, request.param).transcription())


def test_layout_bounds_guess(pair):
    check_layout(*pair)
    trj, trt = pair
    np.testing.assert_array_equal(trt.rep.param_init, trj.rep.param_init)
    np.testing.assert_array_equal(trt.rep.param_lo, trj.rep.param_lo)


def test_constraints_objective(pair):
    check_functions(*pair)


def test_kkt_structure(pair):
    trj, trt = pair
    if any(g.value_fn for g in trt.cost_goals):  # dense in both packages
        assert trj.kkt_structure() is None and trt.kkt_structure() is None
        return
    check_structure(trj, trt)
    st = trt.kkt_structure()
    assert len(st.border_vars) == 3 and len(st.border_cons) == 1  # t, m


def test_block_derivatives():
    check_blocks(jax_oscillator(6, "endpoint_constraint").transcription(),
                 tex.oscillator_mass_study(6, "endpoint_constraint"
                                           ).transcription())


def test_apply_parameters_is_per_lane():
    """Each lane of a batch sees its own mass: the batched constraints
    equal the lane-by-lane ones, and changing one lane's mass moves only
    that lane's rows."""
    tr = tex.oscillator_mass_study(6, "endpoint_constraint").transcription()
    c = tr.make_nlp("cpu").constraints
    Z = np.tile(tr.initial_guess(), (3, 1))
    Z += 0.01 * np.random.default_rng(0).standard_normal(Z.shape)
    Z[:, -1] = [0.7, 1.0, 1.6]
    C = c(torch.as_tensor(Z))
    for k in range(3):
        assert torch.equal(C[k], c(torch.as_tensor(Z[k])))
    Z2 = Z.copy()
    Z2[1, -1] = 1.3
    C2 = c(torch.as_tensor(Z2))
    assert torch.equal(C2[0], C[0]) and torch.equal(C2[2], C[2])
    assert not torch.equal(C2[1], C[1])
