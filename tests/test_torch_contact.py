"""Parity of the port's contact models against the JAX package, float64
on the CPU.

Models: the 50 kg planar point mass of ``test_contact_validation.py`` (a
station contact, k = 1e5, c = 1, mu = 0.7) under each of the three
station force laws, the same point mass on a smooth sphere (r = 0.05,
the sphere defaults of ``test_reactions_and_new_goals.py``), and a
planar link on a three-coordinate custom joint with a sphere off its
origin, whose body-local contact point moves as the link turns (the
frozen point of the JAX package's ``stop_gradient``). States are drawn
with numpy from a fixed seed, around and inside contact; the port
evaluates the batch at once, the JAX package point by point through
``vmap``.

Checked: the contact parameters, ``contact_forces`` and
``applied_generalized_forces``; on the link also the derivatives of the
generalized forces in q and u and the second derivative of w . tau in q,
where a contact point that is not frozen the same way would show; and a
prescribed-kinematics model with a sphere and a muscle, whose passive
forces (``include_muscles=False``) and force-balance constants keep the
contact. Tolerance: relative 1e-12 of the largest magnitude (the same
formulas in float64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu_torch.convert import params_from_numpy
from opensim_moco_tpu_torch.models import MechModelBuilder as TMechModelBuilder
from opensim_moco_tpu_torch.models.model import Model as TModel

torch.set_num_threads(2)

RTOL = 1e-12
JAX = (JMechModelBuilder, JModel)
PORT = (TMechModelBuilder, TModel)


def assert_close(port, ref, rtol=RTOL):
    port = port.detach().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def point_mass(pkg, law):
    """``test_contact_validation.py``'s point mass; ``law`` a station force
    law, or "sphere" for a smooth sphere at the defaults."""
    B, Model = pkg
    b = B(gravity=(0.0, -9.80665, 0.0))
    b.add_body("ptx", mass=0.0, joint_name="tx", kind="prismatic",
               axis=(1, 0, 0), coord_name="tx")
    b.add_body("body", mass=50.0, parent="ptx", joint_name="ty",
               kind="prismatic", axis=(0, 1, 0), coord_name="ty")
    model = Model(b.finalize())
    if law == "sphere":
        model.add_sphere_contact("contact", 1, (0.0, 0.0, 0.0), radius=0.05)
    else:
        model.add_station_contact("contact", body=1, location=(0, 0, 0),
                                  stiffness=1e5, dissipation=1.0,
                                  friction_coefficient=0.7, model=law)
    return model.finalize()


def link(pkg):
    """A planar link (tilt, tx, ty on one custom joint) with a sphere off
    its origin and a station contact at its tip."""
    B, Model = pkg
    axes = (((0, 0, 1), lambda v: v, 0), ((1, 0, 0), None, 0),
            ((0, 1, 0), None, 0), ((1, 0, 0), lambda v: v, 1),
            ((0, 1, 0), lambda v: v, 2), ((0, 0, 1), None, 0))
    b = B(gravity=(0.0, -9.81, 0.0))
    b.add_body("link", mass=1.2, com=(0.1, 0.0, 0.0),
               inertia=np.diag([0.001, 0.004, 0.004]), kind="custom",
               joint_name="planar", coord_names=("rz", "tx", "ty"),
               custom_axes=axes)
    model = Model(b.finalize())
    model.add_sphere_contact("heel", 0, (-0.05, -0.02, 0.0), radius=0.03)
    model.add_station_contact("toe", body=0, location=(0.2, -0.02, 0.0),
                              stiffness=1e6, model="esposito")
    return model.finalize()


def _states(rng, P, nq, lo, hi):
    q = rng.uniform(lo, hi, (P, nq))
    u = 0.5 * rng.standard_normal((P, nq))
    return q, u


def _params(jm):
    pj = jm.default_params()
    return pj, params_from_numpy(jax.device_get(pj), "cpu")


@pytest.mark.parametrize("law", ["ackermann", "meyer", "esposito", "sphere"])
def test_contact_forces_parity(law):
    jm, tm = point_mass(JAX, law), point_mass(PORT, law)
    pj, pt = _params(jm)
    if law != "sphere":
        for key, v in tm.numpy_params()["contact"].items():
            np.testing.assert_array_equal(v, np.asarray(pj["contact"][key]))
    rng = np.random.default_rng(3)
    q, u = _states(rng, 8, 2, -0.01, 0.06 if law == "sphere" else 0.01)
    e0 = jnp.zeros(0)

    @jax.jit
    @jax.vmap
    def jax_all(q, u):
        t = jnp.asarray(0.0)
        return (jm.contact_forces(pj, t, q, u)["contact"],
                jm.applied_generalized_forces(pj, t, q, u, e0, e0))

    f, tau = jax_all(jnp.asarray(q), jnp.asarray(u))
    qt, ut = torch.as_tensor(q), torch.as_tensor(u)
    t0, e = torch.zeros(()), torch.zeros(8, 0, dtype=torch.float64)
    assert_close(tm.contact_forces(pt, t0, qt, ut)["contact"], f)
    assert_close(tm.applied_generalized_forces(pt, t0, qt, ut, e, e), tau)


def test_contact_generalized_force_derivatives():
    jm, tm = link(JAX), link(PORT)
    pj, pt = _params(jm)
    rng = np.random.default_rng(4)
    q, u = _states(rng, 4, 3, -0.3, 0.3)
    q[:, 2] = rng.uniform(-0.01, 0.04, 4)  # the link near the ground
    w = rng.standard_normal(3)
    e0 = jnp.zeros(0)

    def tau_j(q, u):
        return jm.applied_generalized_forces(pj, jnp.asarray(0.0), q, u, e0,
                                             e0)

    @jax.jit
    @jax.vmap
    def jax_all(q, u):
        forces = jm.contact_forces(pj, jnp.asarray(0.0), q, u)
        return (tau_j(q, u), jax.jacfwd(tau_j, 0)(q, u),
                jax.jacfwd(tau_j, 1)(q, u),
                jax.hessian(lambda qq: tau_j(qq, u) @ jnp.asarray(w))(q),
                forces["heel"], forces["toe"])

    ref = jax_all(jnp.asarray(q), jnp.asarray(u))
    t0, e = torch.zeros(()), torch.zeros(0, dtype=torch.float64)
    wt = torch.as_tensor(w)

    def tau_t(q, u):
        return tm.applied_generalized_forces(pt, t0, q, u, e, e)

    def one(q, u):
        forces = tm.contact_forces(pt, t0, q, u)
        return (tau_t(q, u), torch.func.jacfwd(tau_t, 0)(q, u),
                torch.func.jacfwd(tau_t, 1)(q, u),
                torch.func.hessian(lambda qq: (tau_t(qq, u) * wt).sum())(q),
                forces["heel"], forces["toe"])

    port = torch.func.vmap(one)(torch.as_tensor(q), torch.as_tensor(u))
    for a, b in zip(port, ref):
        assert_close(a, b)


def prescribed_slider(pkg, muscle):
    """A vertical slider (1 kg) with a sphere, a muscle from above and a
    reserve, its height prescribed from a table through the ground."""
    B, Model = pkg
    b = B(gravity=(0.0, -9.81, 0.0))
    b.add_body("m", mass=1.0, joint_name="jy", kind="prismatic",
               axis=(0, 1, 0), coord_name="y")
    model = Model(b.finalize())
    model.add_sphere_contact("s1", 0, (0.0, 0.0, 0.0), radius=0.05)
    model.add_muscle("lift", [(-1, (0.0, 0.4, 0.0)), (0, (0.0, 0.0, 0.0))],
                     params=muscle.default_muscle_params(
                         max_isometric_force=60.0, optimal_fiber_length=0.2,
                         tendon_slack_length=0.2),
                     ignore_tendon_compliance=True)
    model.add_coordinate_actuator("reserve", "y", optimal_force=1.0)
    times = np.linspace(0.0, 1.0, 21)
    model.set_position_motion_from_table(
        times, (0.045 + 0.01 * np.cos(2 * np.pi * times))[:, None])
    return model.finalize()


def test_prescribed_model_keeps_contact():
    from opensim_moco_tpu.models import muscle as jdgf
    from opensim_moco_tpu_torch.models import muscle as tdgf

    jm, tm = prescribed_slider(JAX, jdgf), prescribed_slider(PORT, tdgf)
    pj, pt = _params(jm)
    ts = np.linspace(0.0, 1.0, 7)

    @jax.jit
    @jax.vmap
    def jax_all(t):
        c = jm.prescribed_point_constants(pj, t)
        z, x = jnp.zeros(jm.naux), jnp.zeros(jm.nx)
        passive = jm.applied_generalized_forces(
            pj, t, c["q"], c["u"], z, x, include_muscles=False,
            include_controls=False)
        return passive, c["tau_net"]

    passive, tau_net = jax_all(jnp.asarray(ts))
    assert np.abs(np.asarray(passive)).max() > 1.0  # the sphere carries load
    tt = torch.as_tensor(ts)
    c = tm.prescribed_point_constants(pt, tt)
    z, x = torch.zeros(7, tm.naux, dtype=torch.float64), \
        torch.zeros(7, tm.nx, dtype=torch.float64)
    assert_close(tm.applied_generalized_forces(
        pt, tt, c["q"], c["u"], z, x, include_muscles=False,
        include_controls=False), passive)
    assert_close(c["tau_net"], tau_net)
