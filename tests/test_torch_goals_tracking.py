"""Parity of the port's tracking and output goals against the JAX package,
float64 on the CPU: ``MarkerFinalGoal``, ``ControlTrackingGoal``,
``TranslationTrackingGoal``, ``OrientationTrackingGoal``,
``AngularVelocityTrackingGoal``, ``OutputGoal`` and
``AccelerationTrackingGoal`` (with and without its gravity offset).

Model and goals: ``tracking_goals_model.py`` (a body on a custom joint
with three rotations and a forearm on a tilted revolute joint). Inputs
(grid times inside, outside and on the reference samples; states,
controls, reference tables) are drawn with numpy from fixed seeds.

Held: each goal's integrand on a grid of points (the JAX package's
through ``vmap``) and ``hessian_block_local()``; on a problem with all
eight goals as costs at mesh 4 (free final time), f(z) and its
gradient, the KKT structure's index lists (exactly) and the
compressed J and H blocks of the exact Lagrangian, which runs the
angular-velocity goal's ``jvp`` and the acceleration goal's two nested
``jvp``s through the forward dynamics under the Hessian pass. Tolerance:
relative 1e-10 of the largest magnitude (values 1e-12).
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
from test_torch_constrained_common import (check_blocks, check_structure,
                                           jax_nlp, per_lane, points, rel)
from tracking_goals_model import problem

torch.set_num_threads(2)

RTOL = 1e-10
JAX = (JMechModelBuilder, JModel, jocp)
PORT = (TMechModelBuilder, TModel, tocp)


@pytest.fixture(scope="module")
def transcriptions():
    return problem(JAX), problem(PORT)


def _grid(rng, tr, G=7):
    """Grid times (inside, outside and on reference samples) and states,
    controls inside the bounds."""
    t = np.sort(np.concatenate([rng.uniform(-0.2, 1.2, G - 2), [0.0, 1.0]]))
    ny, nx = tr.ny, tr.nx
    Y = rng.uniform(-1.0, 1.0, (G, ny))
    X = rng.uniform(-1.0, 1.0, (G, nx))
    return t, Y, X


def test_goal_integrands_and_locality(transcriptions):
    trj, trt = transcriptions
    rng = np.random.default_rng(5)
    t, Y, X = _grid(rng, trt)
    L = np.zeros((len(t), 0))
    pj = trj.rep.model.default_params()
    pt = trt.rep.model.default_params("cpu")
    for gj, gt in zip(trj.rep.goals, trt.rep.goals):
        assert gt.name == gj.name
        assert gt.hessian_block_local() == gj.hessian_block_local()
        if gt.name == "marker_final":
            continue
        ref = per_lane(lambda tt, yy, xx, ll: gj.integrand(
            trj.rep, tt, yy, xx, ll, pj))(*map(jnp.asarray, (t, Y, X, L)))
        got = gt.integrand(trt.rep, *map(torch.as_tensor, (t, Y, X, L)), pt)
        assert rel(got, ref) <= 1e-12, gt.name
    # the final-marker goal's value at endpoints (both forms)
    gj, gt = trj.rep.goals[0], trt.rep.goals[0]
    fin_t = (torch.as_tensor(t), torch.as_tensor(Y))
    for squared in (True, False):
        gj.squared = gt.squared = squared
        ref = per_lane(lambda tt, yy: gj.value(
            trj.rep, (tt, yy), (tt, yy), 0.0, pj))(jnp.asarray(t),
                                                   jnp.asarray(Y))
        got = gt.value(trt.rep, fin_t, fin_t, 0.0, pt)
        assert rel(got, ref) <= 1e-12
    gj.squared = gt.squared = False


def test_tracking_problem_objective_and_gradient(transcriptions):
    """f and its gradient at the guess and a jittered point (the goals
    change no constraint), and the batch of both points as each alone."""
    trj, trt = transcriptions
    nj, nt = jax_nlp(trj), trt.make_nlp("cpu")
    f_and_grad_j = jax.jit(jax.value_and_grad(nj.objective))
    pts = points(trt)
    for z in pts:
        f_j, grad_j = f_and_grad_j(jnp.asarray(z))
        zt = torch.as_tensor(z)
        assert rel(nt.objective(zt), f_j) <= 1e-12
        assert rel(torch.func.grad(nt.objective)(zt), grad_j) <= RTOL
    F = nt.objective(torch.as_tensor(np.stack(pts)))
    for k, z in enumerate(pts):
        assert rel(F[k], nt.objective(torch.as_tensor(z)).numpy()) <= 1e-14


def test_tracking_problem_structure_and_blocks(transcriptions):
    trj, trt = transcriptions
    check_structure(trj, trt)
    check_blocks(trj, trt)
