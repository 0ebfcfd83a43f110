"""The port's ``dense_factorization="chol-schur"`` against the JAX
package's.

Iterate parity: the hanging muscle with full dynamics at mesh 10, B=4
jittered starts, the bench's IPM options with ``kkt="dense"`` and
``dense_factorization="chol-schur"`` and one step of iterative
refinement (``kkt_refine_iters=1``: the plain solve and the refinement
both run) on both sides, float64 on the CPU. After ``init_fn`` and
three ``body_fn`` steps, per lane, max |port - JAX| <= 1e-6 * max |JAX|
for z, nu, wL and wU (as ``test_torch_ipm.py`` explains for the dense
LU: the KKT's condition numbers near 1e10 amplify last-bit differences of
the derivatives), and mu and the counters equal.

Plus the factor's behaviour on an indefinite trial (NaN in that lane
only, no exception) and a small non-convex problem that needs the
regularization loop to escalate.
"""

import numpy as np
import torch

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.solver import ipm as tipm
from opensim_moco_tpu_torch.solver.nlp import NLP
from opensim_moco_tpu_torch.solver.structured import cholesky_factor
from test_torch_constrained_common import check_iterate_parity

torch.set_num_threads(2)

FULL = dict(ignore_tendon_compliance=False, ignore_activation_dynamics=False,
            tendon_dynamics_implicit=True)
BENCH = dict(tol=3e-3, max_iter=200, bound_relax=1e-6, mu_init=1e-2,
             kappa_eps=100.0, acceptable_tol_factor=30.0, acceptable_iter=10,
             max_rescues=100, kkt="dense", dense_factorization="chol-schur")
RTOL = 1e-6


def test_chol_schur_iterate_parity_with_jax():
    check_iterate_parity(
        jex.hanging_muscle_study(10, **FULL).transcription(),
        tex.hanging_muscle_study(10, **FULL).transcription(),
        dict(BENCH, kkt_refine_iters=1), RTOL)


def test_indefinite_trial_is_nan_in_its_lane():
    """Lane 1 is indefinite: its factor is all NaN, lane 0's is the
    Cholesky factor, and nothing raises."""
    A = torch.tensor([[4.0, 1.0], [1.0, 3.0]], dtype=torch.float64)
    K = torch.stack([A, torch.diag(torch.tensor([1.0, -1.0],
                                                dtype=torch.float64))])
    L = cholesky_factor(K)
    assert torch.allclose(L[0] @ L[0].T, A, rtol=0, atol=1e-15)
    assert torch.isnan(L[1]).all()


def test_nonconvex_problem_regularizes_and_converges():
    """min -z0^2 + z1^2 s.t. z0 + z1 = 1, |z| <= 2: the Hessian is
    indefinite, so the first trials fail (NaN) and delta grows until the
    step is a descent direction; the optimum sits on the bound z0 = 2.
    (At tol 1e-8 neither package's chol-schur converges here: both stall
    at a KKT error of 3e-8 to 5e-8, lane for lane the same.)"""
    def f(z):
        return -z[..., 0] ** 2 + z[..., 1] ** 2

    def c(z):
        return (z[..., 0] + z[..., 1] - 1.0).unsqueeze(-1)

    nlp = NLP(n=2, m=1, objective=f, constraints=c,
              lb=np.full(2, -2.0), ub=np.full(2, 2.0))
    solve = tipm.make_solver(nlp, tipm.IPMOptions(
        tol=1e-6, kkt="dense", dense_factorization="chol-schur"),
        device="cpu")
    res = solve(np.array([[0.3, 0.7], [-0.5, 1.5]]))
    assert res.converged.all()
    np.testing.assert_allclose(res.z.numpy(), [[2.0, -1.0], [2.0, -1.0]],
                               atol=1e-5)
