"""Prescribed kinematics in the port against the JAX package, float64 on
the CPU: the hanging-muscle inverse (also with the activation-effort goal,
``SumSquaredStateGoal``), the six-muscle arm and the arm with a coordinate
coupler (a multiplier in the force balance), each through the ``Inverse``
tool at mesh_interval 0.1 (``test_torch_inverse_common.py``).

* ``Model.prescribed_point_constants`` at the grid times and
  ``prescribed_residual_cached`` at seeded states, controls and
  multipliers: relative 1e-12 of the largest magnitude;
* layout, bounds, guess, constraint groups, c(z) and f(z) folded and
  unfolded, the KKT structure's index arrays and the compressed blocks
  under ``hessian_approximation="objective-only"`` (the tool's setting):
  the checks and tolerances of ``test_torch_constrained_common.py``;
* the port's folded constraints equal its general path at 1e-12 (the JAX
  package's ``tests/test_inverse.py::test_prescribed_fold_matches_unfolded``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_constrained_common import (check_blocks, check_functions,
                                           check_layout, check_structure,
                                           per_lane, rel)
from test_torch_inverse_common import transcriptions

PROBLEMS = ("hanging", "hanging_activation_effort", "arm", "arm_coupler")


@pytest.fixture(scope="module", params=PROBLEMS)
def pair(request):
    return transcriptions(request.param, 0.1)


def test_prescribed_layout(pair):
    trj, trt = pair
    assert trt.prescribed and trt.fold_prescribed and trj.fold_prescribed
    assert not trt.implicit_mb and trt.n_gamma == 0
    assert trt.ny == trt.rep.model.naux
    check_layout(trj, trt)


def test_point_constants_and_cached_residual(pair):
    trj, trt = pair
    mj, mt = trj.rep.model, trt.rep.model
    ts = np.asarray(trj.taus)  # the window is [0, 1]
    pj = trj.rep.apply_parameters(jnp.zeros(0))
    cj = per_lane(lambda t: mj.prescribed_point_constants(pj, t))(
        jnp.asarray(ts))
    pt = mt.default_params("cpu")
    ct = mt.prescribed_point_constants(pt, torch.as_tensor(ts))
    assert sorted(ct) == sorted(cj)
    for k in cj:
        assert rel(ct[k], cj[k]) <= 1e-12, k
    rng = np.random.default_rng(1)
    G = len(ts)
    z = rng.uniform(0.05, 1.0, (G, mt.naux))
    x = rng.uniform(0.05, 1.0, (G, mt.nx))
    lam = rng.standard_normal((G, mt.nphi))
    rj = per_lane(lambda c, a, b, e: mj.prescribed_residual_cached(
        pj, c, a, b, e))(cj, jnp.asarray(z), jnp.asarray(x), jnp.asarray(lam))
    rt = mt.prescribed_residual_cached(
        pt, ct, *(torch.as_tensor(a) for a in (z, x, lam)))
    assert rel(rt, rj) <= 1e-12


@pytest.mark.parametrize("fold", [True, False])
def test_constraints_objective(pair, fold):
    trj, trt = pair
    trj.fold_prescribed = trt.fold_prescribed = fold
    try:
        check_functions(trj, trt)
    finally:
        trj.fold_prescribed = trt.fold_prescribed = True


def test_fold_matches_unfolded(pair):
    """The port's own folded path against its general path at a jittered
    point with the window pinned (JAX tests/test_inverse.py:75)."""
    _, trt = pair
    rng = np.random.default_rng(3)
    z = trt.initial_guess()
    z[2:] += 0.05 * rng.standard_normal(trt.n - 2)
    zt = torch.as_tensor(z)
    c_fold = trt.constraints_fn("cpu")(zt)
    trt.fold_prescribed = False
    try:
        c_ref = trt.constraints_fn("cpu")(zt)
    finally:
        trt.fold_prescribed = True
    torch.testing.assert_close(c_fold, c_ref, rtol=1e-12, atol=1e-12)


def test_kkt_structure(pair):
    check_structure(*pair)


def test_block_derivatives_objective_only(pair):
    check_blocks(*pair, objective_only=True)
