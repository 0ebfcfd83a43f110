"""Path constraints in the port against the JAX package: the generic
``Problem.add_path_constraint`` (one- and two-sided components) and both
helpers of ``ocp/path_constraints.py``, on the double pendulum at mesh 6
under both schemes. Checks and tolerances in
``test_torch_constrained_common.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu.ocp import path_constraints as jpc
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.ocp import path_constraints as tpc
from test_torch_constrained_common import (check_blocks, check_functions,
                                           check_layout, check_structure)

PAIRS = ((1, (0.0, -1.0, 0.0), -1, (0.5, 0.0, 0.0)),
         (0, (0.0, -0.5, 0.0), 1, (0.0, -0.3, 0.0)))


def _helpers(pkg, pc, stack):
    """Double pendulum with the control-bound and frame-distance helpers
    and a generic two-component constraint whose second component is an
    equality."""
    study = pkg.double_pendulum_swingup_study(6)
    prob = study.problem
    prob.add_path_constraint("controls", *pc.control_bound_constraint(
        ["/forceset/tau0", "/forceset/tau1"], lambda t: -50.0 + 10.0 * t,
        lambda t: 60.0 - 5.0 * t))
    prob.add_path_constraint("distance", *pc.frame_distance_constraint(
        PAIRS, 0.1, 3.0))
    prob.add_path_constraint("projected", *pc.frame_distance_constraint(
        PAIRS[:1], 0.2, 2.5, projection=(0.0, 0.0, 1.0)))
    prob.add_path_constraint("mixed", stack, [-1.0, 0.5], [1.0, 0.5])
    return study


def _jax_mixed(rep, t, y, x, lam, p):
    return jnp.stack([y[0] - y[1], y[2] + 0.1 * x[0]])


def _port_mixed(rep, t, y, x, lam, p):
    return torch.stack([y[..., 0] - y[..., 1],
                        y[..., 2] + 0.1 * x[..., 0]], -1)


CASES = {
    "elbow_hermite_simpson": lambda pkg: pkg.double_pendulum_swingup_study(
        6, "hermite-simpson", True),
    "elbow_trapezoidal": lambda pkg: pkg.double_pendulum_swingup_study(
        6, "trapezoidal", True),
    "helpers": lambda pkg: (_helpers(jex, jpc, _jax_mixed) if pkg is jex
                            else _helpers(tex, tpc, _port_mixed)),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def pair(request):
    return (CASES[request.param](jex).transcription(),
            CASES[request.param](tex).transcription())


def test_layout_bounds_guess(pair):
    check_layout(*pair)
    trt = pair[1]
    assert trt.n_pc_slack and trt.rep.path_constraints


def test_constraints_objective(pair):
    check_functions(*pair)


def test_kkt_structure(pair):
    check_structure(*pair)


def test_block_derivatives(pair):
    check_blocks(*pair)


def test_slack_bounds_and_rows():
    """The elbow's slacks carry [-2, 2] at every mesh point, and its rows
    are q1 minus the slack there."""
    trt = tex.double_pendulum_swingup_study(6, with_path_constraint=True
                                            ).transcription()
    lb, ub = trt.bounds()
    a, b = trt.offsets["pc_slack"]
    assert b - a == 7
    np.testing.assert_array_equal(lb[a:b], -2.0)
    np.testing.assert_array_equal(ub[a:b], 2.0)
    z = trt.initial_guess()
    z = z + np.random.default_rng(5).uniform(-1, 1, z.shape)
    c = trt.make_nlp("cpu").constraints(torch.as_tensor(z)).numpy()
    q1 = z[trt.offsets["states"][0]:trt.offsets["states"][1]].reshape(
        trt.G, trt.ny)[::2, 1]
    np.testing.assert_allclose(c[-7:], q1 - z[a:b], rtol=0, atol=1e-15)
