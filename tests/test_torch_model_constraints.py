"""Parity of the port's generalized springs and kinematic constraints
against the JAX package.

A double pendulum with a spring/damper on each coordinate (stiffness,
rest length and viscosity all non-zero) and a torque actuator on each;
then the same pendulum with each kind of kinematic constraint (the
generic one and the six named ones). Evaluated at points drawn with numpy
from a fixed seed, float64 on the CPU: ``applied_generalized_forces``,
``phi``, ``constraint_jacobian`` and both multibody forms with random
multipliers. The port evaluates the batch at once; the JAX side point by
point through ``vmap``. Tolerance: relative 1e-12 of the largest
magnitude (same formulas; only the order of a few sums differs; the port
forms G^T lam by one reverse pass, the JAX package by a product with the
forward-mode Jacobian).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu.models import MechModelBuilder as JBuilder
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu_torch.convert import params_from_numpy
from opensim_moco_tpu_torch.models import MechModelBuilder as TBuilder
from opensim_moco_tpu_torch.models.model import Model as TModel
from test_torch_constrained_common import per_lane

torch.set_num_threads(2)

RTOL = 1e-12
P = 6  # points


def assert_close(port, ref, rtol=RTOL):
    port = port.detach().cpu().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def double_pendulum(Builder, Model, springs=True):
    b = Builder(gravity=(0, -9.81, 0))
    b.add_body("link1", mass=1.0, com=(0, -0.5, 0),
               inertia=np.diag([0, 0, 1.0 / 12.0]), joint_name="j0",
               kind="revolute", axis=(0, 0, 1), coord_name="q0")
    b.add_body("link2", mass=1.3, com=(0.1, -0.4, 0),
               inertia=np.diag([0.01, 0.02, 0.1]), parent="link1",
               joint_name="j1", kind="revolute", axis=(0, 0, 1),
               tree_r=(0, -1.0, 0), coord_name="q1")
    model = Model(b.finalize())
    model.add_coordinate_actuator("tau0", "q0", optimal_force=2.0)
    model.add_coordinate_actuator("tau1", "q1", optimal_force=1.5)
    if springs:
        model.add_spring_generalized_force("s0", "q0", stiffness=3.0,
                                           rest_length=0.2, viscosity=0.4)
        model.add_spring_generalized_force("s1", 1, stiffness=-1.5,
                                           rest_length=-0.3, viscosity=-1.0)
    return model


def inputs(model, seed):
    rng = np.random.default_rng(seed)
    nq = model.nq
    return dict(t=np.zeros(P), q=rng.uniform(-1.5, 1.5, (P, nq)),
                u=rng.standard_normal((P, nq)),
                z=np.zeros((P, 0)), x=rng.standard_normal((P, model.nx)),
                lam=rng.standard_normal((P, model.nphi)),
                udot=rng.standard_normal((P, nq)))


def evaluate(jm, tm, inp):
    """(port, JAX) pairs of the forces and both multibody forms."""
    pj = jm.default_params()
    pt = params_from_numpy(jax.device_get(pj), "cpu")
    J = {k: jnp.asarray(v) for k, v in inp.items()}
    T = {k: torch.as_tensor(v) for k, v in inp.items()}
    args = ("t", "q", "u", "z", "x")
    lam_t = T["lam"] if tm.nphi else None
    return [
        (tm.applied_generalized_forces(pt, *[T[a] for a in args]),
         per_lane(lambda *a: jm.applied_generalized_forces(pj, *a))(
             *[J[a] for a in args])),
        (tm.multibody_explicit(pt, *[T[a] for a in args], lam_t),
         per_lane(lambda *a: jm.multibody_explicit(pj, *a))(
             *[J[a] for a in args + ("lam",)])),
        (tm.multibody_implicit_residual(pt, *[T[a] for a in args], lam_t,
                                        T["udot"]),
         per_lane(lambda *a: jm.multibody_implicit_residual(pj, *a))(
             *[J[a] for a in args + ("lam", "udot")])),
    ]


def test_spring_parity():
    jm = double_pendulum(JBuilder, JModel).finalize()
    tm = double_pendulum(TBuilder, TModel).finalize()
    pj = jax.device_get(jm.default_params())
    pt = tm.numpy_params()
    assert sorted(pt["spring"]) == sorted(pj["spring"])
    for k, v in pj["spring"].items():
        np.testing.assert_array_equal(pt["spring"][k], v)
    for port, ref in evaluate(jm, tm, inputs(jm, 0)):
        assert_close(port, ref)
    # the spring term on its own: forces differ from the spring-free model
    # by exactly -k (q - q_rest) - c u
    bare = double_pendulum(TBuilder, TModel, springs=False).finalize()
    inp = inputs(jm, 1)
    T = {k: torch.as_tensor(v) for k, v in inp.items()}
    diff = (tm.applied_generalized_forces(tm.default_params("cpu"), T["t"],
                                          T["q"], T["u"], T["z"], T["x"]) -
            bare.applied_generalized_forces(bare.default_params("cpu"),
                                            T["t"], T["q"], T["u"], T["z"],
                                            T["x"])).numpy()
    k, r, c = (np.array([3.0, -1.5]), np.array([0.2, -0.3]),
               np.array([0.4, -1.0]))
    np.testing.assert_allclose(diff, -k * (inp["q"] - r) - c * inp["u"],
                               rtol=0, atol=1e-14)


def _coupling(v):
    return 0.5 * v * v - 0.2 * v


CONSTRAINTS = {
    "generic": lambda m, jax_side: m.add_kinematic_constraint(
        "gen", (lambda mp, q: jnp.stack([q[1] - q[0] ** 2, q[0] * q[1]]))
        if jax_side else
        (lambda mp, q: torch.stack([q[..., 1] - q[..., 0] ** 2,
                                    q[..., 0] * q[..., 1]], -1))),
    "point": lambda m, _: (
        m.add_point_constraint("pt", 1, (1.0, 0, 0), -1, (2.0, 0.0, 0.0)),
        m.add_point_constraint("pt2", 0, (0.2, -0.1, 0), 1, (0.0, 0.3, 0))),
    "weld": lambda m, _: (
        m.add_weld_constraint("weld", 1, -1, (1.0, 0, 0), (2.0, 0.0, 0.0)),
        m.add_weld_constraint("weld2", 0, 1, (0.1, 0, 0), (0.0, 0.2, 0))),
    "point_on_line": lambda m, _: (
        m.add_point_on_line_constraint("pol", -1, (0.0, 0.0, 0.0),
                                       (1.0, 0.0, 0.0), 1, (1.0, 0.0, 0.0)),
        m.add_point_on_line_constraint("pol2", 0, (0.0, -0.5, 0.0),
                                       (0.3, 1.0, 0.0), 1, (0.2, 0.0, 0.1))),
    "constant_distance": lambda m, _: m.add_constant_distance_constraint(
        "dist", -1, (0.0, 0.0, 0.0), 1, (1.0, 0.0, 0.0), 2.0),
    "locked_coordinate": lambda m, _: m.add_locked_coordinate_constraint(
        "lock", "q1", 0.3),
    "coordinate_coupler": lambda m, _: m.add_coordinate_coupler_constraint(
        "cc", "q1", "q0", _coupling),
}


@pytest.mark.parametrize("kind", sorted(CONSTRAINTS))
def test_kinematic_constraint_parity(kind):
    jm = double_pendulum(JBuilder, JModel, springs=False)
    tm = double_pendulum(TBuilder, TModel, springs=False)
    CONSTRAINTS[kind](jm, True)
    CONSTRAINTS[kind](tm, False)
    jm.finalize()
    tm.finalize()
    assert tm.nphi == jm.nphi > 0
    assert tm.multiplier_names() == jm.multiplier_names()
    pj = jm.default_params()
    pt = params_from_numpy(jax.device_get(pj), "cpu")
    inp = inputs(jm, 2)
    q = torch.as_tensor(inp["q"])
    assert_close(tm.phi(pt, q), per_lane(lambda a: jm.phi(pj, a))(
        jnp.asarray(inp["q"])))
    assert_close(tm.constraint_jacobian(pt, q), per_lane(
        lambda a: jm.constraint_jacobian(pj, a))(jnp.asarray(inp["q"])))
    for port, ref in evaluate(jm, tm, inp):
        assert_close(port, ref)
    # one point without leading dims evaluates like the batch
    assert_close(tm.constraint_jacobian(pt, q[0]),
                 tm.constraint_jacobian(pt, q)[0].numpy(), rtol=1e-15)
