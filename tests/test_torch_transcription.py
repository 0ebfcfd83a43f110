"""Parity of the PyTorch port's transcription against the JAX package.

Layout, bounds and the initial guess are the same numpy computations on
both sides and must agree exactly. The NLP functions are compared in
float64 at the bounds-midpoint guess and at a jittered point drawn with
numpy from a fixed seed:

* c(z) and f(z): relative 1e-12 of the largest magnitude (same formulas,
  only summation order differs);
* the dense constraint Jacobian (``jacfwd``) and the Lagrangian Hessian
  (``jacfwd(grad(L))``): relative 1e-9 of the largest magnitude
  (forward-over-reverse accumulates more rounding than one evaluation).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu.parallel import batch_guesses as jax_batch_guesses
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.convert import problem_layout_from_numpy
from opensim_moco_tpu_torch.parallel import batch_guesses

torch.set_num_threads(2)

HANGING = {
    "hanging_rigid": dict(ignore_tendon_compliance=True,
                          ignore_activation_dynamics=True),
    "hanging_full_implicit": dict(ignore_tendon_compliance=False,
                                  ignore_activation_dynamics=False,
                                  tendon_dynamics_implicit=True),
    "hanging_compliant_explicit_trapezoidal": dict(
        ignore_tendon_compliance=False, ignore_activation_dynamics=False,
        tendon_dynamics_implicit=False, scheme="trapezoidal",
        multibody_dynamics_mode="explicit"),
}
CASES = sorted(HANGING) + ["sliding_mass"]


def _studies(case, mesh=10):
    if case == "sliding_mass":
        return (jex.sliding_mass_study(mesh, "trapezoidal"),
                tex.sliding_mass_study(mesh, "trapezoidal"))
    return (jex.hanging_muscle_study(mesh, **HANGING[case]),
            tex.hanging_muscle_study(mesh, **HANGING[case]))


def _points(tr, seed=0):
    """The guess and a jittered point inside the bounds."""
    z0 = tr.initial_guess()
    lb, ub = tr.bounds()
    rng = np.random.default_rng(seed)
    width = np.where(np.isfinite(ub - lb), ub - lb, 1.0)
    z1 = np.clip(z0 + 0.05 * width * rng.uniform(-1, 1, z0.shape), lb, ub)
    return {"guess": z0, "jittered": z1}


def assert_close(port, ref, rtol):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


@pytest.mark.parametrize("case", CASES)
def test_layout_bounds_guess_exact(case):
    sj, st = _studies(case)
    trj, trt = sj.transcription(), st.transcription()
    assert trt.offsets == trj.offsets
    assert trt.n == trj.n and trt.G == trj.G
    np.testing.assert_array_equal(trt.taus, trj.taus)
    np.testing.assert_array_equal(trt.quad_w, trj.quad_w)
    for a, b in zip(trt.bounds(), trj.bounds()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trt.initial_guess(), trj.initial_guess())
    assert trt.constraint_group_info() == trj.constraint_group_info()
    np.testing.assert_array_equal(
        batch_guesses(trt, 5, scale=0.05, seed=3),
        np.asarray(jax_batch_guesses(trj, 5, scale=0.05, seed=3)))
    lay = problem_layout_from_numpy(trt.offsets, *trt.bounds(),
                                    trt.initial_guess(), "cpu")
    assert lay["offsets"] == trj.offsets
    np.testing.assert_array_equal(lay["z"].numpy(), trj.initial_guess())
    # pack/unpack round trip on the port side
    z = _points(trt)["jittered"]
    blocks = trt.unpack(torch.as_tensor(z))
    repacked = trt.pack(*[b.numpy() for b in blocks])
    np.testing.assert_array_equal(repacked, z)


@pytest.mark.parametrize("case", CASES)
def test_constraints_objective_parity(case):
    sj, st = _studies(case)
    trj, trt = sj.transcription(), st.transcription()
    nj, nt = trj.make_nlp(), trt.make_nlp("cpu")
    assert (nt.n, nt.m) == (nj.n, nj.m)
    c_j, f_j = jax.jit(nj.constraints), jax.jit(nj.objective)
    pts = _points(trt)
    for z in pts.values():
        zt = torch.as_tensor(z)
        assert_close(nt.constraints(zt), c_j(jnp.asarray(z)), 1e-12)
        assert_close(nt.objective(zt), f_j(jnp.asarray(z)), 1e-12)
    # a batch of points evaluates like each point alone
    Z = torch.as_tensor(np.stack(list(pts.values())))
    C = nt.constraints(Z)
    F = nt.objective(Z)
    for k, z in enumerate(pts.values()):
        zt = torch.as_tensor(z)
        assert_close(C[k], nt.constraints(zt).numpy(), 1e-14)
        assert_close(F[k], nt.objective(zt).numpy(), 1e-14)


@pytest.mark.parametrize("case", CASES)
def test_jacobian_hessian_parity(case):
    sj, st = _studies(case)
    trj, trt = sj.transcription(), st.transcription()
    nj, nt = trj.make_nlp(), trt.make_nlp("cpu")
    nu = np.random.default_rng(1).standard_normal(nj.m)
    nu_t = torch.as_tensor(nu)
    J_j = jax.jit(jax.jacfwd(nj.constraints))
    W_j = jax.jit(jax.jacfwd(jax.grad(
        lambda z: nj.objective(z) + nj.constraints(z) @ jnp.asarray(nu))))
    W_t = jacfwd(grad(lambda z: nt.objective(z) +
                      (nt.constraints(z) * nu_t).sum(-1)))
    for z in _points(trt).values():
        zt = torch.as_tensor(z)
        assert_close(jacfwd(nt.constraints)(zt), J_j(jnp.asarray(z)), 1e-9)
        assert_close(W_t(zt), W_j(jnp.asarray(z)), 1e-9)
