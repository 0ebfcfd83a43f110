"""Parity of the port's forward simulation against the JAX package, float64
on the CPU: ``Model.state_derivatives`` and ``utils/rollout.py``
(``rollout``, ``time_stepping_guess``).

Models: the hanging muscle, with activation dynamics and an implicit
compliant tendon for the derivatives, and at mesh 10 with a rigid tendon,
without and with activation dynamics, for the rollouts; the planar
contact leg (``opensim_moco_tpu_torch/example_models/contact_leg.py``:
custom joints, two contact spheres, four DGF muscles), each package's
model from its own builders, for the derivatives (the JAX package
compiles its forward dynamics, no NLP). Inputs are drawn with numpy from
a fixed seed.

Held: ``state_derivatives`` at 8 points within 1e-12 of the JAX
package's largest magnitude: on the hanging muscle with and without the
implicit tendon's derivative variables (without them its entry is 0, as
in the JAX package), on the leg at poses of its squat; ``rollout`` (RK4,
controls linear in time) and ``time_stepping_guess`` within 1e-10; the
passive pendulum's rollout within 2.5e-3 of the small-angle solution
0.1 cos(sqrt(g) t), the JAX package's own test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models import muscle as jdgf
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu.utils.splines import CubicSpline as JCubicSpline
from opensim_moco_tpu.utils.rollout import rollout as jax_rollout
from opensim_moco_tpu.utils.rollout import \
    time_stepping_guess as jax_time_stepping_guess
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.example_models import contact_leg
from opensim_moco_tpu_torch.models import MechModelBuilder
from opensim_moco_tpu_torch.models import muscle as dgf
from opensim_moco_tpu_torch.models.model import Model
from opensim_moco_tpu_torch.utils.splines import CubicSpline
from opensim_moco_tpu_torch.utils.rollout import (rollout,
                                                  time_stepping_guess)
from test_torch_constrained_common import one_blas_thread, per_lane, rel

IMPLICIT = dict(ignore_tendon_compliance=False,
                ignore_activation_dynamics=False,
                tendon_dynamics_implicit=True)
RIGID = dict(ignore_tendon_compliance=True, ignore_activation_dynamics=True)
ACTIVATION = dict(ignore_tendon_compliance=True,
                  ignore_activation_dynamics=False)


def models(kw, mesh=10):
    """Both packages' transcriptions of the hanging muscle."""
    return (jex.hanging_muscle_study(mesh, **kw).transcription(),
            tex.hanging_muscle_study(mesh, **kw).transcription())


def state_derivative_inputs(trt, rng, P=8):
    """P points of (t, q, u, z, x, zeta) inside the bounds."""
    m = trt.rep.model
    lb, ub = trt.rep.y_lo, trt.rep.y_hi
    lo = np.where(np.isfinite(lb), lb, -1.0)
    hi = np.where(np.isfinite(ub), ub, 1.0)
    y = rng.uniform(lo, hi, (P, trt.ny))
    # tendon forces and activations away from the bounds' edges
    y[:, 2 * m.nq:] = rng.uniform(0.2, 0.8, (P, trt.ny - 2 * m.nq))
    t = rng.uniform(0.0, 1.0, P)
    x = rng.uniform(0.05, 0.95, (P, trt.nx))
    zeta = rng.normal(size=(P, max(1, len(m._implicit_aux))))
    return t, y, x, zeta


def test_state_derivatives_match_jax():
    trj, trt = models(IMPLICIT)
    mj, mt = trj.rep.model, trt.rep.model
    t, y, x, zeta = state_derivative_inputs(trt, np.random.default_rng(0))
    pj, pt = mj.default_params(), mt.default_params("cpu")
    nq = mt.nq

    def jfn(with_zeta):
        def f(tt, yy, xx, zz):
            q, u, z = mj.split_state(yy)
            return mj.state_derivatives(pj, tt, q, u, z, xx,
                                        jnp.zeros(0, yy.dtype),
                                        zz if with_zeta else None)
        return per_lane(f)

    T = [torch.as_tensor(a) for a in (t, y, x, zeta)]
    for with_zeta in (True, False):
        q, u, z = mt.split_state(T[1])
        got = mt.state_derivatives(pt, T[0], q, u, z, T[2], None,
                                   T[3] if with_zeta else None)
        with one_blas_thread():
            ref = np.asarray(jfn(with_zeta)(*(jnp.asarray(a) for a in
                                              (t, y, x, zeta))))
        assert got.shape == (8, trt.ny)
        assert rel(got, ref) <= 1e-12
        # the speeds lead, and the implicit tendon's entry is its zeta or 0
        np.testing.assert_array_equal(got[:, :nq].numpy(), y[:, nq:2 * nq])
        np.testing.assert_array_equal(got[:, -1].numpy(),
                                      zeta[:, 0] if with_zeta else 0.0)


def test_contact_leg_state_derivatives_match_jax():
    mj = contact_leg.build_leg(JMechModelBuilder, JModel, JCubicSpline,
                               jdgf)
    mt = contact_leg.build_leg(MechModelBuilder, Model, CubicSpline, dgf)
    assert mt.state_names() == mj.state_names()
    rng = np.random.default_rng(0)
    P, nq, ny = 8, mt.nq, len(mt.state_names())
    t, q_ref, _ = contact_leg.reference()
    rows = rng.integers(0, len(t), P)
    y = np.concatenate([q_ref[rows] + rng.normal(0, 0.02, (P, nq)),
                        rng.normal(0, 0.5, (P, nq)),
                        rng.uniform(0.1, 0.9, (P, ny - 2 * nq))], axis=1)
    x = rng.uniform(0.05, 0.95, (P, len(mt.control_names())))
    ts = t[rows]
    pj = mj.default_params()

    def f(tt, yy, xx):
        q, u, z = mj.split_state(yy)
        return mj.state_derivatives(pj, tt, q, u, z, xx,
                                    jnp.zeros(0, yy.dtype))

    with one_blas_thread():
        ref = np.asarray(per_lane(f)(jnp.asarray(ts), jnp.asarray(y),
                                     jnp.asarray(x)))
    q, u, z = mt.split_state(torch.as_tensor(y))
    got = mt.state_derivatives(mt.default_params("cpu"),
                               torch.as_tensor(ts), q, u, z,
                               torch.as_tensor(x), None)
    assert np.isfinite(ref).all()
    assert rel(got, ref) <= 1e-12


@pytest.mark.parametrize("kw", [RIGID, ACTIVATION],
                         ids=["rigid", "activation"])
def test_rollout_matches_jax(kw):
    trj, trt = models(kw)
    rng = np.random.default_rng(1)
    tg = np.sort(np.concatenate([[0.0, 0.3], rng.uniform(0.0, 0.3, 19)]))
    X = rng.uniform(0.05, 0.95, (len(tg), trt.nx))
    y0 = trt.initial_guess()[trt.offsets["states"][0]:][:trt.ny]
    got = rollout(trt.rep.model, trt.rep.model.default_params("cpu"), tg,
                  X, torch.as_tensor(y0), substeps=4)
    with one_blas_thread():
        ref = np.asarray(jax_rollout(trj.rep.model,
                                     trj.rep.model.default_params(), tg, X,
                                     y0, substeps=4))
    assert got.shape == ref.shape == (len(tg), trt.ny)
    assert np.isfinite(ref).all()
    assert rel(got, ref) <= 1e-10
    if kw is ACTIVATION:
        with one_blas_thread():
            ref = np.asarray(jax_time_stepping_guess(trj))
        got = time_stepping_guess(trt, device="cpu")
        assert rel(got, ref) <= 1e-10


def test_rollout_matches_analytic_pendulum():
    b = MechModelBuilder(gravity=(0, -9.81, 0))
    b.add_body("rod", mass=1.0, com=(0, -1.0, 0), kind="revolute",
               axis=(0, 0, 1), coord_name="theta")
    model = Model(b.finalize()).finalize()
    tg = np.linspace(0, 2.0, 41)
    ys = rollout(model, model.default_params("cpu"), tg, np.zeros((41, 0)),
                 torch.tensor([0.1, 0.0], dtype=torch.float64), substeps=20)
    expected = 0.1 * np.cos(np.sqrt(9.81) * tg)
    np.testing.assert_allclose(ys[:, 0].numpy(), expected, atol=2.5e-3)
    # the JAX package's model gives the same rollout
    jb = JMechModelBuilder(gravity=(0, -9.81, 0))
    jb.add_body("rod", mass=1.0, com=(0, -1.0, 0), kind="revolute",
                axis=(0, 0, 1), coord_name="theta")
    jm = JModel(jb.finalize()).finalize()
    ref = jax_rollout(jm, jm.default_params(), tg, np.zeros((41, 0)),
                      jnp.array([0.1, 0.0]), substeps=20)
    assert rel(ys, ref) <= 1e-12


def test_rollout_needs_a_card_unless_asked_for_the_cpu():
    _, trt = models(RIGID)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        time_stepping_guess(trt)
