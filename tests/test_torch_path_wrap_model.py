"""Parity of the port's path points, wraps, body wrenches and joint
reactions against the JAX package.

A three-link chain (revolute joints about z, a tilted axis and x, so the
cylinders see the paths in 3D) carries one muscle per path feature: a
cylinder with two candidate segments (one candidate outside the path,
dropped); two cylinders chained on one segment, one given as a legacy
inline ``("wrap", spec)`` marker and listed after the distal one (the
model sorts them); a moving point on a muscle that also wraps, on one
quadrant; a conditional point. Some tendons are rigid, some compliant.
An external load with a torque acts on the foot. Poses, speeds, states
and controls are drawn with numpy from a fixed seed; among them each wrap
engages at some and not at others, and the conditional point is on and
off the path.

Compared with the JAX package (one jitted function called point by point,
``per_lane``: its compile is most of this file's time): the path lengths, their rates and
the moment arms, ``applied_generalized_forces`` (with each term left out
in turn), ``applied_body_wrenches`` and ``joint_reaction``, within 1e-10
of the largest magnitude (float64; the port takes a wrapped or
moving-point muscle's generalized force from a ``vjp`` of its length, the
JAX package from one ``vjp`` of all). The port's derivatives of the
muscles' generalized forces in q and u (the solver's tangents through
that ``vjp``) against central differences and reverse mode. A ``JointReactionGoal`` on the knee as the only cost of a
mesh-2 problem on the chain: its integrand at the grid points against the
JAX package's reactions there, and the compressed objective Hessian
blocks against the port's dense Hessian. Last, the JAX package's analytic
pendulum reaction test, on the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu.models.wrap import WrapCylinderSpec as JWrap
from opensim_moco_tpu_torch import ocp as tocp
from opensim_moco_tpu_torch.convert import params_from_numpy
from opensim_moco_tpu_torch.models import MechModelBuilder as TMechModelBuilder
from opensim_moco_tpu_torch.models.model import Model as TModel
from opensim_moco_tpu_torch.models.wrap import WrapCylinderSpec as TWrap
from opensim_moco_tpu_torch.solver import structured as ts
from opensim_moco_tpu_torch.solver.kkt import CompiledStructure
from test_torch_constrained_common import per_lane

torch.set_num_threads(2)

RTOL = 1e-10
P = 16  # poses
ARGS = ("t", "q", "u", "z", "x")
FLAGS = ((True, True), (False, False), (True, False), (False, True))
KNEE = 1  # the shank's index: the knee's reaction acts on it
MEASURES = {"force-x": 1.0, "force-y": 1.0, "moment-z": 10.0}


def assert_close(port, ref, rtol=RTOL):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _fx(x):
    return 0.04 + 0.01 * x


def _fy(x):
    return -0.05 + 0.02 * x * x


def chain(B, Model, Wrap, lib):
    """The chain with the package's ``MechModelBuilder``, ``Model`` and
    ``WrapCylinderSpec``; ``lib`` (torch or jax.numpy) makes the external
    load's functions of time. Finalized."""
    b = B(gravity=(0.0, -9.81, 0.0))
    b.add_body("thigh", mass=5.0, com=(0.0, -0.2, 0.0),
               inertia=np.diag([0.1, 0.02, 0.1]), joint_name="hip",
               kind="revolute", axis=(0, 0, 1), coord_name="q0")
    b.add_body("shank", mass=3.0, com=(0.0, -0.2, 0.01),
               inertia=np.diag([0.05, 0.01, 0.05]), parent="thigh",
               joint_name="knee", kind="revolute", axis=(0.2, 0.0, 1.0),
               tree_r=(0.0, -0.4, 0.0), coord_name="q1")
    b.add_body("foot", mass=1.0, com=(0.05, -0.02, 0.0),
               inertia=np.diag([0.002, 0.004, 0.004]), parent="shank",
               joint_name="ankle", kind="revolute", axis=(1, 0, 0),
               tree_r=(0.0, -0.4, 0.02), coord_name="q2")
    model = Model(b.finalize())
    knee = Wrap("knee_cyl", 0, (0.0, -0.4, 0.0), (0.1, 0.05, 0.0), 0.05)
    femur = Wrap("femur_cyl", 0, (0.0, -0.38, 0.0), (0.0, 0.1, 0.0), 0.03)
    shank = Wrap("shank_cyl", 1, (0.0, -0.1, 0.0), (0.0, 0.0, 0.2), 0.03,
                 "-x")
    front = Wrap("front_cyl", 0, (0.05, -0.3, 0.0), (0.0, 0.0, 0.0), 0.02,
                 "+y")
    kw = dict(ignore_activation_dynamics=False)
    model.add_muscle("vas", [(0, (0.03, -0.2, 0.0)), (0, (0.04, -0.35, 0.0)),
                             (1, (0.04, -0.05, 0.0))],
                     wraps=((knee, (0, 1, 7)),), **kw)
    model.add_muscle("gas", [(0, (-0.02, -0.3, 0.01)), ("wrap", femur),
                             (2, (-0.05, 0.0, 0.0))],
                     wraps=((shank, (0,)),), ignore_tendon_compliance=True,
                     **kw)
    model.add_muscle("rf", [("fixed", -1, (0.08, -0.05, 0.0)),
                            ("moving", 1, ((_fx, 1), (_fy, 1), (None, 0)))],
                     wraps=((front, (0,)),), ignore_tendon_compliance=True,
                     **kw)
    model.add_muscle("cond", [(-1, (-0.05, 0.0, 0.0)),
                              ("conditional", 0, (-0.04, -0.2, 0.0), 1,
                               -0.5, 0.5),
                              (1, (-0.03, -0.1, 0.0))], **kw)
    model.add_coordinate_actuator("tau1", "q1", optimal_force=20.0)

    def force(t):
        return lib.stack([10 * lib.sin(t), 200 + 5 * lib.cos(t), 0 * t], -1)

    def point(t):
        return lib.stack([0.1 * t, -0.9 + 0.0 * t, 0.02 + 0.0 * t], -1)

    def torque(t):
        return lib.stack([0.5 + 0 * t, -0.2 * t, 1.5 * lib.cos(t)], -1)

    model.add_external_force("grf", 2, force, point, torque)
    return model.finalize()


def _reaction_problem(model):
    """The port's mesh-2 problem on the chain whose only cost is a
    ``JointReactionGoal`` on the knee; the transcription."""
    prob = tocp.Problem(model)
    prob.set_time_bounds(0.0, 1.0)
    prob.add_goal(tocp.JointReactionGoal(
        name="knee", joint=KNEE, measures=tuple(MEASURES),
        measure_weights=MEASURES))
    study = tocp.Study(prob)
    study.set_solver_options(num_mesh_intervals=2)
    return study.transcription()


def _quantities(m, p, lib, t, q, u, z, x, udot):
    """Every quantity compared with the JAX package, of model ``m`` at one
    point (JAX, under ``vmap``) or at a batch of points (the port)."""
    if lib is jnp:
        R = jax.jacfwd(lambda a: m.path_lengths(p, a))(q)
        lam = jnp.zeros(0)
    else:
        R = torch.func.vmap(torch.func.jacfwd(
            lambda a: m.path_lengths(p, a)))(q)
        lam = q.new_zeros(q.shape[:-1] + (0,))
    lMT, vMT = m.muscle_path_kinematics(p, q, u)
    out = {"lengths": m.path_lengths(p, q), "lMT": lMT, "vMT": vMT, "R": R,
           "wrenches": m.applied_body_wrenches(p, t, q, u, z, x),
           "reaction": m.joint_reaction(p, t, q, u, z, x, lam),
           "reaction_udot": m.joint_reaction(p, t, q, u, z, x, lam,
                                             udot=udot)}
    for k, flags in enumerate(FLAGS):
        out[f"f_app{k}"] = m.applied_generalized_forces(p, t, q, u, z, x,
                                                        *flags)
    return out


@pytest.fixture(scope="module")
def models():
    jm = chain(JMechModelBuilder, JModel, JWrap, jnp)
    tm = chain(TMechModelBuilder, TModel, TWrap, torch)
    pj = jm.default_params()
    pt = params_from_numpy(jax.device_get(pj), "cpu")
    rng = np.random.default_rng(7)
    d = {"t": rng.uniform(0.0, 1.0, P),
         "q": rng.uniform(-1.2, 1.2, (P, 3)),
         "u": rng.standard_normal((P, 3)),
         "z": rng.uniform(0.1, 0.9, (P, jm.naux)),
         "x": rng.uniform(0.05, 0.95, (P, len(jm.control_names()))),
         "udot": rng.standard_normal((P, 3))}
    # the reaction goal's problem at a point drawn the same way, and its
    # grid points appended to the compared ones
    tr = _reaction_problem(tm)
    lb, ub = tr.bounds()
    z = np.clip(tr.initial_guess() + rng.uniform(-0.5, 0.5, tr.n), lb, ub)
    t0, tf, Y, X = tr.unpack(z)[:4]
    nq = tm.nq
    grid = {"t": t0 + (tf - t0) * np.asarray(tr.taus), "q": Y[:, :nq],
            "u": Y[:, nq:2 * nq], "z": Y[:, 2 * nq:], "x": X,
            "udot": np.zeros((tr.G, nq))}
    d = {k: np.concatenate([v, grid[k]]) for k, v in d.items()}
    jax_fn = per_lane(lambda *a: _quantities(jm, pj, jnp, *a))
    ref = jax.device_get(jax_fn(*[jnp.asarray(d[a]) for a in ARGS],
                                jnp.asarray(d["udot"])))
    return jm, tm, pt, d, ref, (tr, z)


def test_normalized_paths(models):
    jm, tm = models[:2]
    for a, b in zip(tm.muscles, jm.muscles):
        assert a.path == b.path
        assert [(s.name, c) for s, c in a.wraps] == \
            [(s.name, c) for s, c in b.wraps]
    assert tm.muscles[0].wraps[0][1] == (0, 1)  # candidate 7 dropped
    # the inline marker joins the listed wrap on the segment it was in
    assert [s.name for s, _ in tm.muscles[1].wraps] == ["shank_cyl",
                                                        "femur_cyl"]
    assert tm.muscles[1].wraps[1][1] == (0,)
    assert tm.state_names() == jm.state_names()
    assert tm.control_names() == jm.control_names()


def test_features_switch_over_the_poses(models):
    """Each wrap engages at some poses and not at others; the conditional
    point is on and off the path."""
    _, tm, pt, d = models[:4]
    q = _t(d["q"][:P])
    frames = tm.mech.frames(pt["mech"], q)
    for ms in tm.muscles[:3]:
        pts = [tm._path_point_world(frames, q, pt_) for pt_ in ms.path]
        detour = tm._wrap_detours(frames, q, ms, pts).numpy()
        assert (detour > 1e-6).any() and (detour == 0).any(), ms.name
    active = tm._active(q, tm.muscles[3].path[1]).numpy()
    assert active.any() and not active.all()


@pytest.mark.parametrize("group", [
    ("lengths", "lMT", "vMT", "R"),
    tuple(f"f_app{k}" for k in range(len(FLAGS))),
    ("wrenches", "reaction", "reaction_udot")],
    ids=["path_kinematics", "generalized_forces", "wrenches_reactions"])
def test_against_jax(models, group):
    _, tm, pt, d, ref = models[:5]
    port = _quantities(tm, pt, torch, *[_t(d[a]) for a in ARGS],
                       _t(d["udot"]))
    for name in group:
        assert_close(port[name], ref[name])


def test_generalized_force_derivatives(models):
    """The port's derivatives of the muscles' generalized forces (f_app
    less f_app without muscles: the frozen load point drops out), forward
    mode through the local ``vjp`` of the wrapped muscles: in q against
    central differences (step 1e-5), relative 1e-6; in u (small: only the
    rigid tendons' force-velocity) against reverse mode, 1e-10."""
    _, tm, pt, d = models[:4]

    def f(*args):
        return (tm.applied_generalized_forces(pt, *args) -
                tm.applied_generalized_forces(pt, *args, False))

    for k in range(4):
        a = [_t(d[n][k]) for n in ARGS]
        J = torch.func.jacfwd(f, argnums=1)(*a)
        cols = []
        for j in range(3):
            e = torch.zeros(3, dtype=torch.float64)
            e[j] = 1e-5
            hi, lo = list(a), list(a)
            hi[1], lo[1] = a[1] + e, a[1] - e
            cols.append((f(*hi) - f(*lo)) / 2e-5)
        assert_close(J, torch.stack(cols, -1), rtol=1e-6)
        assert_close(torch.func.jacfwd(f, argnums=2)(*a),
                     torch.func.jacrev(f, argnums=2)(*a))


def test_joint_reaction_goal(models):
    """The goal's integrand against the JAX package's reactions at the
    grid points; its compressed objective Hessian blocks (the seeded
    ``jvp``s every integrand goal goes through) against the port's dense
    Hessian of the objective."""
    _, tm, pt, d, ref, (tr, z) = models
    G = tr.G
    goal = tr.rep.goals[0]
    t0, tf, Y, X = tr.unpack(z)[:4]
    val = goal.integrand(tr.rep, _t(t0 + (tf - t0) * np.asarray(tr.taus)),
                         _t(Y), _t(X), _t(np.zeros((G, 0))), pt)
    reac = ref["reaction"][-G:, KNEE]
    expected = sum(w * reac[:, k] ** 2 for k, w in zip((3, 4, 2),
                                                        MEASURES.values()))
    assert (expected > 1.0).all()  # the knee carries load
    assert_close(val, expected)
    nlp = tr.make_nlp("cpu")
    st = nlp.structure
    cs = CompiledStructure(st.var_blocks, st.con_blocks, st.border_vars,
                           st.border_cons, nlp.n, nlp.m)
    bd = ts.BlockDerivatives(cs, nlp.constraints, "cpu")
    Z = _t(z)[None]

    def f_grad(zz, _):
        return torch.func.grad(lambda q: nlp.objective(q).sum())(zz)

    H = ts.dense_H_from_blocks(bd.hess_blocks(f_grad, Z, torch.zeros(
        1, nlp.m, dtype=torch.float64)), bd.ix)[0]
    assert_close(H, torch.func.hessian(nlp.objective)(_t(z)))


def _pendulum(L=0.7, m=2.3):
    b = TMechModelBuilder(gravity=(0.0, -9.81, 0.0))
    b.add_body("rod", mass=m, com=(L, 0, 0),
               inertia=((0, 0, 0), (0, 0, 0), (0, 0, 0)),
               joint_name="pin", kind="revolute", axis=(0, 0, 1),
               coord_name="theta")
    model = TModel(b.finalize())
    model.add_coordinate_actuator("tau", "theta", optimal_force=1.0,
                                  min_control=-50, max_control=50)
    return model.finalize(), L, m


def test_pendulum_joint_reaction_analytic():
    """The JAX package's test (``tests/test_reactions_and_new_goals.py``)
    on the port: a point-mass pendulum's pin reaction force is
    m (a_com - g); the reaction moment about the pin axis is the applied
    motor torque (it acts between the two bodies, so the pin transmits
    it)."""
    model, L, m = _pendulum()
    p = model.default_params("cpu")
    theta, omega, tau = 0.35, 1.4, 2.0
    q = _t([theta])
    u = _t([omega])
    x = _t([tau])
    z = _t(np.zeros(0))
    lam = _t(np.zeros(0))
    g = 9.81
    t = _t(0.0)
    udot = model.multibody_explicit(p, t, q, u, z, x, lam)
    alpha = float(udot[0])
    # analytic: I alpha = tau - m g L cos(theta)
    np.testing.assert_allclose(alpha,
                               (tau - m * g * L * np.cos(theta)) /
                               (m * L * L), rtol=1e-12)
    reac = model.joint_reaction(p, t, q, u, z, x, lam).numpy()[0]
    e_r = np.array([np.cos(theta), np.sin(theta), 0.0])
    e_t = np.array([-np.sin(theta), np.cos(theta), 0.0])
    a_com = -L * omega ** 2 * e_r + L * alpha * e_t
    f_expected = m * (a_com - np.array([0.0, -g, 0.0]))
    np.testing.assert_allclose(reac[3:], f_expected, atol=1e-9)
    np.testing.assert_allclose(reac[2], tau, atol=1e-9)
    np.testing.assert_allclose(reac[:2], 0.0, atol=1e-9)
