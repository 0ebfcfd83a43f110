"""Parity of the port's external loads and custom control forces against
the JAX package.

``parse_external_loads`` and ``ModOpAddExternalLoads`` read the
ExternalLoads XML and .mot that ``example_models/walker2d.py`` writes
(here into a temporary folder); both packages' splines are compared at
times across the data, with and without the low-pass. The loads then act
on a small model whose feet (``calcn_r``, ``calcn_l``) turn about all
three axes, with one more load that carries a torque: the generalized
forces, the body wrenches and the joint reactions at states drawn with
numpy from a fixed seed, within 1e-12 of the largest magnitude (the JAX
side one jitted function, point by point), and the port's derivatives in q and t with
the load points frozen. Last, a custom control force, the linear-tangent
thrust of ``tests/test_linear_tangent.py`` built by hand in both
packages: the layout, c(z), f(z) and the gradient of f.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu import examples as _jex  # noqa: F401  (import order)
from opensim_moco_tpu import ocp as jocp
from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu.utils.osim import \
    parse_external_loads as jparse_external_loads
from opensim_moco_tpu.utils.processors import \
    ModOpAddExternalLoads as JModOpAddExternalLoads
from opensim_moco_tpu_torch import ocp as tocp
from opensim_moco_tpu_torch.convert import params_from_numpy
from opensim_moco_tpu_torch.example_models import walker2d
from opensim_moco_tpu_torch.models import MechModelBuilder as TMechModelBuilder
from opensim_moco_tpu_torch.models.model import Model as TModel
from opensim_moco_tpu_torch.models.spatial import mv
from opensim_moco_tpu_torch.utils import ModOpAddExternalLoads
from opensim_moco_tpu_torch.utils.osim import parse_external_loads
from test_torch_constrained_common import (check_functions, check_layout,
                                           per_lane)

torch.set_num_threads(2)

RTOL = 1e-12
P = 16


def assert_close(port, ref, rtol=RTOL):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


@pytest.fixture(scope="module")
def xml(tmp_path_factory):
    return walker2d.write_external_loads(
        str(tmp_path_factory.mktemp("loads")))


@pytest.mark.parametrize("lowpass_hz", [None, 6.0])
def test_parse_external_loads(xml, lowpass_hz):
    port = parse_external_loads(xml, lowpass_hz=lowpass_hz)
    ref = jparse_external_loads(xml, lowpass_hz=lowpass_hz)
    assert [(s["name"], s["body_name"]) for s in port] == \
        [(s["name"], s["body_name"]) for s in ref] == \
        [("Right_GRF", "calcn_r"), ("Left_GRF", "calcn_l")]
    times = np.linspace(-0.2, 0.65, 53)
    for a, b in zip(port, ref):
        for key in ("force_fn", "point_fn", "torque_fn"):
            assert_close(a[key](_t(times)), jax.vmap(b[key])(
                jnp.asarray(times)))
    # the forces are the walker's GRFs, the points its feet's
    t, grf = walker2d.grf_reference()["Right_GRF"]
    if lowpass_hz is None:
        assert_close(port[0]["force_fn"](_t(t)), grf)


def feet(B, Model, lib):
    """Two feet named as the walker's, each on a chain of three revolute
    joints (x, y, z) off the ground, and a third load with a torque on
    the left foot; ``lib`` makes its functions of time. Not finalized."""
    b = B(gravity=(0.0, -9.81, 0.0))
    for s, side in (("r", 0.1), ("l", -0.1)):
        parent = "ground"
        for k, axis in enumerate(((1, 0, 0), (0, 1, 0), (0, 0, 1))):
            name = f"calcn_{s}" if k == 2 else f"seg{k}_{s}"
            b.add_body(name, mass=1.0 + k, com=(0.05, -0.02 * k, 0.01),
                       inertia=np.diag([0.01, 0.02, 0.015]), parent=parent,
                       joint_name=f"j{k}_{s}", kind="revolute", axis=axis,
                       tree_r=(0.0, 0.5, side) if k == 0
                       else (0.02, -0.1, 0.01), coord_name=f"q{k}_{s}")
            parent = name
    model = Model(b.finalize())

    def force(t):
        return lib.stack([lib.sin(3 * t), 20 + lib.cos(t), 2 * t], -1)

    def point(t):
        return lib.stack([0.3 * t, 0.1 + 0 * t, -0.1 + 0.05 * t], -1)

    def torque(t):
        return lib.stack([1.0 + 0 * t, -2 * t, 3 * lib.cos(2 * t)], -1)

    model.add_external_force("hand", 5, force, point, torque)
    return model


@pytest.fixture(scope="module")
def loaded(xml):
    jm = JModOpAddExternalLoads(xml)(feet(JMechModelBuilder, JModel, jnp))
    tm = ModOpAddExternalLoads(xml)(feet(TMechModelBuilder, TModel, torch))
    jm.finalize()
    tm.finalize()
    pj = jm.default_params()
    pt = params_from_numpy(jax.device_get(pj), "cpu")
    rng = np.random.default_rng(5)
    nq = jm.nq
    data = {"t": rng.uniform(0.0, walker2d.HALF_CYCLE, P),
            "q": rng.uniform(-1.5, 1.5, (P, nq)),
            "u": rng.standard_normal((P, nq)),
            "z": np.zeros((P, 0)), "x": np.zeros((P, 0))}
    return jm, tm, pj, pt, data


def _quantities(m, p, lib, t, q, u, z, x):
    """The compared quantities of model ``m`` at one point (JAX, under
    ``vmap``) or at a batch of points (the port)."""
    lam = jnp.zeros(0) if lib is jnp else q.new_zeros(q.shape[:-1] + (0,))
    return {"f_app": m.applied_generalized_forces(p, t, q, u, z, x),
            "wrenches": m.applied_body_wrenches(p, t, q, u, z, x),
            "reaction": m.joint_reaction(p, t, q, u, z, x, lam)}


ARGS = ("t", "q", "u", "z", "x")


def test_external_loads_on_a_model(loaded):
    jm, tm, pj, pt, d = loaded
    assert [ef["name"] for ef in tm.external_forces] == \
        [ef["name"] for ef in jm.external_forces] == \
        ["hand", "Right_GRF", "Left_GRF"]
    ref = per_lane(lambda *a: _quantities(jm, pj, jnp, *a))(
        *[jnp.asarray(d[a]) for a in ARGS])
    port = _quantities(tm, pt, torch, *[_t(d[a]) for a in ARGS])
    for name in ref:
        assert_close(port[name], ref[name])


def test_external_loads_derivatives(loaded):
    """The port's derivatives of f_app in q and t hold the body-local load
    points frozen (no derivative through their choice, as the JAX
    package's ``stop_gradient``): forward mode against central
    differences (step 1e-6) of the loads' generalized forces with each
    point held where it is at the unperturbed (t, q), relative 1e-7."""
    _, tm, _, pt, d = loaded
    p = pt["mech"]
    for k in range(3):
        t0, q0, u = (_t(d[n][k]) for n in ("t", "q", "u"))
        kin0 = tm.mech.kinematics(p, q0)
        locs = [(ef, mv(kin0[ef["body"]].A,
                        ef["point_fn"](t0) - kin0[ef["body"]].o))
                for ef in tm.external_forces]

        def frozen(tt, qq):
            kin = tm.mech.kinematics(p, qq, u)
            return tm.mech.point_forces_to_generalized(
                kin, qq, [(ef["body"], loc, ef["force_fn"](tt))
                          for ef, loc in locs],
                [(ef["body"], ef["torque_fn"](tt)) for ef, _ in locs
                 if ef["torque_fn"] is not None])

        def f(tt, qq):
            return tm.applied_generalized_forces(pt, tt, qq, u, _t([]),
                                                 _t([]))

        assert_close(f(t0, q0), frozen(t0, q0))
        for argnum, x0 in ((0, t0), (1, q0)):
            J = torch.func.jacfwd(f, argnums=argnum)(t0, q0)
            cols = []
            for j in range(x0.numel()):
                e = torch.zeros_like(x0).reshape(-1)
                e[j] = 1e-6
                e = e.reshape(x0.shape)
                hi, lo = [t0, q0], [t0, q0]
                hi[argnum], lo[argnum] = x0 + e, x0 - e
                cols.append((frozen(*hi) - frozen(*lo)) / 2e-6)
            fd = torch.stack(cols, -1).reshape(J.shape)
            assert_close(J, fd, rtol=1e-7)


A = 5.0
H = 1.0


def linear_tangent(B, Model, ocp, lib):
    """``tests/test_linear_tangent.py``'s study (MocoStudyFactory's linear
    tangent steering) with the package's classes: a planar point mass
    without actuators, pushed by the thrust A (cos u, sin u) of one custom
    control force; mesh 10. Returns the transcription."""
    b = B(gravity=(0.0, 0.0, 0.0))
    b.add_body("ptx", mass=0.0, joint_name="tx", kind="prismatic",
               axis=(1, 0, 0), coord_name="tx")
    b.add_body("body", mass=1.0, parent="ptx", joint_name="ty",
               kind="prismatic", axis=(0, 1, 0), coord_name="ty")
    model = Model(b.finalize())

    def thrust(p, t, q, u, angle):
        return A * lib.stack([lib.cos(angle), lib.sin(angle)], -1)

    model.add_custom_control_force("actuator", thrust,
                                   min_control=-0.5 * np.pi,
                                   max_control=0.5 * np.pi)
    model.finalize()
    prob = ocp.Problem(model)
    prob.set_time_bounds(0, 1.0)
    prob.set_state_info("/jointset/tx/tx/value", (0, 10), 0)
    prob.set_state_info("/jointset/ty/ty/value", (0, H), 0, H)
    prob.set_state_info("/jointset/tx/tx/speed", (0, 10), 0)
    prob.set_state_info("/jointset/ty/ty/speed", (0, 10), 0, 0)
    prob.set_control_info("/forceset/actuator", (-0.5 * np.pi, 0.5 * np.pi))
    prob.add_goal(ocp.CustomGoal(
        name="final_speed",
        value_fn=lambda rep, initial, final, integral, p:
        -final[1][..., 2]))
    study = ocp.Study(prob)
    study.set_solver_options(transcription_scheme="hermite-simpson",
                             num_mesh_intervals=10)
    return study.transcription()


def test_custom_control_force_linear_tangent():
    trj = linear_tangent(JMechModelBuilder, JModel, jocp, jnp)
    trt = linear_tangent(TMechModelBuilder, TModel, tocp, torch)
    m = trt.rep.model
    assert m.control_names() == trj.rep.model.control_names() == \
        ["/forceset/actuator"]
    np.testing.assert_array_equal(m.default_control_bounds(),
                                  trj.rep.model.default_control_bounds())
    check_layout(trj, trt)
    # with zero multipliers the Lagrangian's gradient is f's
    check_functions(trj, trt, np.zeros(sum(
        size for _, size in trt.constraint_group_info())))
