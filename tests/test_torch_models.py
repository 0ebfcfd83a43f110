"""Parity of the PyTorch port's models against the JAX package.

Every input is drawn with numpy from a fixed seed and handed to both
packages in float64. The port evaluates whole batches at once (leading
dimensions); the JAX side is evaluated point by point through ``vmap``.

Tolerance: relative 1e-12 of the largest magnitude in each compared
array. Both sides run the same formulas in float64; only the order of a
few sums differs, which moves the last bits.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models import muscle as jdgf
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.convert import params_from_numpy
from opensim_moco_tpu_torch.models import MechModelBuilder as TMechModelBuilder
from opensim_moco_tpu_torch.models import muscle as tdgf
from opensim_moco_tpu_torch.models.model import Model as TModel

torch.set_num_threads(2)

RTOL = 1e-12
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_close(port, ref, rtol=RTOL, broadcast=False):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    if broadcast:  # a constant (input-independent) result keeps its shape
        port = np.broadcast_to(port, ref.shape)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


# ------------------------------------------------------------------ import


def test_port_imports_no_jax():
    """Every module of the port imports with JAX blocked."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import opensim_moco_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') or "
        "k.startswith('opensim_moco_tpu.') for k, v in sys.modules.items() "
        "if v is not None), 'a JAX module was imported'\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


# --------------------------------------------------------------- mechanics


def _hanging_slider(B):
    b = B(gravity=(9.81, 0.0, 0.0))
    b.add_body("body", mass=0.5, joint_name="joint", kind="prismatic",
               axis=(1, 0, 0), coord_name="height")
    return b.finalize()


def _double_pendulum(B):
    b = B(gravity=(0, -9.81, 0))
    b.add_body("link1", mass=1.0, com=(0, -0.5, 0),
               inertia=np.diag([0, 0, 1.0 / 12.0]), joint_name="j0",
               kind="revolute", axis=(0, 0, 1), coord_name="q0")
    b.add_body("link2", mass=1.0, com=(0, -0.5, 0),
               inertia=np.diag([0, 0, 1.0 / 12.0]), parent="link1",
               joint_name="j1", kind="revolute", axis=(0, 0, 1),
               tree_r=(0, -1.0, 0), coord_name="q1")
    return b.finalize()


def _offset_chain(B):
    """Oblique axes, rotated joint frames on both sides, a weld and a
    prismatic joint behind a revolute one."""
    c, s = np.cos(0.3), np.sin(0.3)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    Rx = np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    b = B(gravity=(0.1, -9.81, 0.3))
    b.add_body("a", mass=1.3, com=(0.1, -0.4, 0.05),
               inertia=np.diag([0.02, 0.03, 0.04]), kind="revolute",
               axis=(0.2, 0.1, 1.0), coord_name="qa", tree_E=Rz,
               tree_r=(0.0, 0.1, 0.0), child_E=Rx, child_r=(0.0, 0.05, 0.0))
    b.add_body("w", mass=0.4, com=(0.0, -0.1, 0.0), inertia=(0.01, 0.01,
                                                             0.02),
               parent="a", kind="weld", tree_r=(0.0, -0.8, 0.0))
    b.add_body("p", mass=0.7, com=(0.05, 0.0, 0.0),
               inertia=np.diag([0.01, 0.02, 0.02]), parent="w",
               kind="prismatic", axis=(1.0, 0.2, 0.0), coord_name="qp",
               tree_E=Rx, child_r=(0.02, 0.0, 0.01))
    b.add_body("r", mass=0.9, com=(0.0, -0.3, 0.0),
               inertia=np.diag([0.03, 0.01, 0.03]), parent="p",
               kind="revolute", axis=(1.0, 0.0, 0.0), coord_name="qr",
               tree_r=(0.1, -0.2, 0.0), child_E=Rz)
    return b.finalize()


MECH_MODELS = {"hanging_slider": _hanging_slider,
               "double_pendulum": _double_pendulum,
               "offset_chain": _offset_chain}


@pytest.mark.parametrize("name", sorted(MECH_MODELS))
def test_mech_dynamics_parity(name):
    jm = MECH_MODELS[name](JMechModelBuilder)
    tm = MECH_MODELS[name](TMechModelBuilder)
    assert tm.nq == jm.nq and tm.coord_names == jm.coord_names
    pj = jm.default_params()
    pt = params_from_numpy(jax.device_get(pj), "cpu")
    for k, v in tm.numpy_params().items():
        np.testing.assert_array_equal(v, np.asarray(pj[k]))
    rng = np.random.default_rng(0)
    P = 6
    q, u, ud, tau = (rng.standard_normal((P, jm.nq)) for _ in range(4))

    def jv(fn, *args):
        return jax.vmap(fn)(*[jnp.asarray(a) for a in args])

    assert_close(tm.rnea(pt, t(q), t(u), t(ud)),
                 jv(lambda a, b, c: jm.rnea(pj, a, b, c), q, u, ud))
    assert_close(tm.mass_matrix(pt, t(q)),
                 jv(lambda a: jm.mass_matrix(pj, a), q))
    assert_close(tm.bias_forces(pt, t(q), t(u)),
                 jv(lambda a, b: jm.bias_forces(pj, a, b), q, u))
    assert_close(tm.forward_dynamics(pt, t(q), t(u), t(tau)),
                 jv(lambda a, b, c: jm.forward_dynamics(pj, a, b, c),
                    q, u, tau), rtol=1e-10)
    frames_t = tm.frames(pt, t(q))
    frames_j = jv(lambda a: jm.frames(pj, a), q)
    for (At, ot), (Aj, oj) in zip(frames_t, frames_j):
        assert_close(At, Aj, broadcast=True)
        assert_close(ot, oj, broadcast=True)
    assert_close(tm.mass_center(pt, t(q)),
                 jv(lambda a: jm.mass_center(pj, a), q))
    last = tm.nb - 1
    assert_close(tm.station_position(pt, t(q), last, (0.1, -0.2, 0.3)),
                 jv(lambda a: jm.station_position(pj, a, last,
                                                  (0.1, -0.2, 0.3)), q))


@pytest.mark.parametrize("kind", ["custom", "free"])
def test_unported_joint_kinds_raise(kind):
    """A custom joint without its coordinates and axes, and the "free"
    kind, which neither package has (a free joint is a custom joint with
    six driven axes), are refused, as the JAX builder refuses them."""
    b = TMechModelBuilder()
    with pytest.raises(ValueError):
        b.add_body("x", mass=1.0, kind=kind)


# ------------------------------------------------------------------ muscle


def _muscle_params(nm, rng):
    lists = []
    for _ in range(nm):
        lists.append(dict(
            max_isometric_force=rng.uniform(20.0, 1500.0),
            optimal_fiber_length=rng.uniform(0.05, 0.15),
            tendon_slack_length=rng.uniform(0.05, 0.3),
            pennation_angle_at_optimal=rng.uniform(0.0, 0.3),
            max_contraction_velocity=rng.uniform(5.0, 15.0),
            active_force_width_scale=rng.uniform(0.8, 1.5),
            fiber_damping=rng.uniform(0.0, 0.05),
            passive_fiber_strain_at_one_norm_force=rng.uniform(0.4, 0.7),
            tendon_strain_at_one_norm_force=rng.uniform(0.03, 0.1)))
    pj = jdgf.stack_muscle_params([jdgf.default_muscle_params(**d)
                                   for d in lists])
    pn = tdgf.stack_muscle_params([tdgf.default_muscle_params(**d)
                                   for d in lists])
    for k in pn:
        np.testing.assert_array_equal(pn[k], np.asarray(pj[k]))
    return pj, params_from_numpy(pn, "cpu")


def _muscle_inputs(nm, P, rng):
    """Physically sensible states: path lengths that keep the fibers near
    their optimal length, tendon forces in (0.05, 1.5)."""
    return dict(
        exc=rng.uniform(0.01, 1.0, (P, nm)),
        act=rng.uniform(0.05, 1.0, (P, nm)),
        ft=rng.uniform(0.05, 1.5, (P, nm)),
        dft=rng.uniform(-5.0, 5.0, (P, nm)),
        vMT=rng.uniform(-0.5, 0.5, (P, nm)),
        nfl=rng.uniform(0.4, 1.6, (P, nm)),
        nfv=rng.uniform(-0.9, 0.9, (P, nm)))


def _dgf_cases():
    """(name, port fn, jax fn): each takes (params, inputs, lMT)."""
    ign = np.array([False, True, False])
    return {
        "active_force_length": lambda d, p, x, L: d.active_force_length(
            x["nfl"], p["active_force_width_scale"]),
        "force_velocity": lambda d, p, x, L: d.force_velocity(x["nfv"]),
        "force_velocity_inverse": lambda d, p, x, L:
            d.force_velocity_inverse(d.force_velocity(x["nfv"])),
        "passive_force_length": lambda d, p, x, L: d.passive_force_length(
            x["nfl"], p["passive_fiber_strain_at_one_norm_force"],
            ignore=ign),
        "tendon_force_multiplier": lambda d, p, x, L:
            d.tendon_force_multiplier(
                1.0 + 0.05 * x["ft"],
                d.tendon_kT(p["tendon_strain_at_one_norm_force"])),
        "tendon_force_length_inverse": lambda d, p, x, L:
            d.tendon_force_length_inverse(
                x["ft"], d.tendon_kT(p["tendon_strain_at_one_norm_force"])),
        "activation_dynamics": lambda d, p, x, L: d.activation_dynamics(
            x["exc"], x["act"], p["activation_time_constant"],
            p["deactivation_time_constant"]),
        "rigid_tendon_force": lambda d, p, x, L: d.rigid_tendon_force(
            p, x["act"], L, x["vMT"], ign),
        "explicit_tendon_dynamics": lambda d, p, x, L:
            d.explicit_tendon_dynamics(p, x["act"], x["ft"], L, x["vMT"],
                                       ign),
        "implicit_tendon_residual": lambda d, p, x, L:
            d.implicit_tendon_residual(p, x["act"], x["ft"], x["dft"], L,
                                       x["vMT"], ign),
        "tendon_force_from_state": lambda d, p, x, L:
            d.tendon_force_from_state(p, x["ft"]),
        "linearized_equilibrium_residual_derivative": lambda d, p, x, L:
            d.linearized_equilibrium_residual_derivative(
                p, x["act"], x["ft"], x["dft"], L, x["vMT"], ign),
    }


@pytest.mark.parametrize("case", sorted(_dgf_cases()))
def test_dgf_parity(case):
    rng = np.random.default_rng(1)
    nm, P = 3, 7
    pj, pt = _muscle_params(nm, rng)
    x = _muscle_inputs(nm, P, rng)
    lopt = np.asarray(pj["optimal_fiber_length"])
    lMT = np.asarray(pj["tendon_slack_length"]) * 1.02 + lopt * x["nfl"]
    fn = _dgf_cases()[case]
    xj = {k: jnp.asarray(v) for k, v in x.items()}
    xt = {k: t(v) for k, v in x.items()}
    if case == "linearized_equilibrium_residual_derivative":
        # the JAX function takes one point at a time (grad of a sum)
        ref = jax.vmap(lambda xx, L: fn(jdgf, pj, xx, L))(xj,
                                                          jnp.asarray(lMT))
    else:
        ref = fn(jdgf, pj, xj, jnp.asarray(lMT))
    assert_close(fn(tdgf, pt, xt, t(lMT)), ref)


# ------------------------------------------------------------------- model

HANGING_VARIANTS = {
    "rigid": dict(ignore_tendon_compliance=True,
                  ignore_activation_dynamics=True),
    "full_implicit": dict(ignore_tendon_compliance=False,
                          ignore_activation_dynamics=False,
                          tendon_dynamics_implicit=True),
    "compliant_explicit": dict(ignore_tendon_compliance=False,
                               ignore_activation_dynamics=False,
                               tendon_dynamics_implicit=False),
}


@pytest.mark.parametrize("variant", sorted(HANGING_VARIANTS))
def test_hanging_model_parity(variant):
    kw = HANGING_VARIANTS[variant]
    jmodel = jex.hanging_muscle_study(5, **kw).problem.model
    tmodel = tex.hanging_muscle_study(5, **kw).problem.model
    assert tmodel.state_names() == jmodel.state_names()
    assert tmodel.control_names() == jmodel.control_names()
    assert tmodel.multiplier_names() == jmodel.multiplier_names()
    assert tmodel.coordinate_paths() == jmodel.coordinate_paths()
    for a, b in zip(tmodel.default_state_bounds() +
                    tmodel.default_control_bounds(),
                    jmodel.default_state_bounds() +
                    jmodel.default_control_bounds()):
        np.testing.assert_array_equal(a, b)
    assert tmodel.n_implicit_aux == jmodel.n_implicit_aux
    for k, v in tmodel._mv.items():
        np.testing.assert_array_equal(v, jmodel._mv[k])

    pj = jmodel.default_params()
    pt = params_from_numpy(jax.device_get(pj), "cpu")
    rng = np.random.default_rng(2)
    P = 5
    nq, naux, nx = jmodel.nq, jmodel.naux, jmodel.nx
    q = 0.15 + 0.01 * rng.standard_normal((P, nq))
    u = 0.3 * rng.standard_normal((P, nq))
    ud = rng.standard_normal((P, nq))
    zz = rng.uniform(0.1, 0.9, (P, naux))
    x = rng.uniform(0.05, 0.95, (P, nx))
    zeta = rng.standard_normal((P, max(jmodel.n_implicit_aux, 1)))[
        :, :jmodel.n_implicit_aux]
    tt = np.zeros(P)

    def jv(fn, *args):
        return jax.vmap(fn)(*[jnp.asarray(a) for a in args])

    T = [t(a) for a in (tt, q, u, zz, x, ud, zeta)]
    tt_, q_, u_, z_, x_, ud_, ze_ = T
    assert_close(tmodel.path_lengths(pt, q_),
                 jv(lambda a: jmodel.path_lengths(pj, a), q))
    for pt_, pj_ in zip(tmodel.muscle_path_kinematics(pt, q_, u_),
                        jv(lambda a, b: jmodel.muscle_path_kinematics(
                            pj, a, b), q, u)):
        assert_close(pt_, pj_)
    assert_close(tmodel.tau_controls(pt, x_),
                 jv(lambda a: jmodel.tau_controls(pj, a), x))
    assert_close(tmodel.applied_generalized_forces(pt, tt_, q_, u_, z_, x_),
                 jv(lambda a, b, c, d, e: jmodel.applied_generalized_forces(
                     pj, a, b, c, d, e), tt, q, u, zz, x))
    lam = np.zeros((P, 0))
    assert_close(tmodel.multibody_explicit(pt, tt_, q_, u_, z_, x_, None),
                 jv(lambda a, b, c, d, e, f: jmodel.multibody_explicit(
                     pj, a, b, c, d, e, f), tt, q, u, zz, x, lam))
    assert_close(tmodel.multibody_implicit_residual(pt, tt_, q_, u_, z_, x_,
                                                    None, ud_),
                 jv(lambda a, b, c, d, e, f, g:
                    jmodel.multibody_implicit_residual(pj, a, b, c, d, e, f,
                                                       g),
                    tt, q, u, zz, x, lam, ud))
    aux_args = (ze_,) if jmodel.n_implicit_aux else (None,)
    if jmodel.n_implicit_aux:
        ref = jv(lambda a, b, c, d, e, f: jmodel.aux_dynamics(
            pj, a, b, c, d, e, f), tt, q, u, zz, x, zeta)
        ref_res = jv(lambda a, b, c, d, e, f: jmodel.implicit_aux_residuals(
            pj, a, b, c, d, e, f), tt, q, u, zz, x, zeta)
    else:
        ref = jv(lambda a, b, c, d, e: jmodel.aux_dynamics(
            pj, a, b, c, d, e), tt, q, u, zz, x)
        ref_res = np.zeros((P, 0))
    assert_close(tmodel.aux_dynamics(pt, tt_, q_, u_, z_, x_, *aux_args),
                 ref)
    assert_close(tmodel.implicit_aux_residuals(pt, tt_, q_, u_, z_, x_,
                                               ze_), ref_res)
    for mi in range(len(jmodel.muscles)):
        for a, b in zip(tmodel.muscle_state(z_, x_, mi),
                        jv(lambda c, d: jmodel.muscle_state(c, d, mi), zz, x)):
            if b is None:
                assert a is None
            else:
                assert_close(a, b)


@pytest.mark.parametrize("method,args", [
    # the ids the cases had while contacts were listed here too
    pytest.param("add_external_force", ("e", 0, None, None),
                 id="add_external_force-args2"),
    pytest.param("add_custom_control_force", ("f", None),
                 id="add_custom_control_force-args3"),
])
def test_unported_model_components_raise(method, args):
    model = TModel(_hanging_slider(TMechModelBuilder))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        getattr(model, method)(*args)


def test_unported_path_features_raise():
    model = TModel(_hanging_slider(TMechModelBuilder))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.add_muscle("m", [("fixed", -1, (0, 0, 0)),
                               ("conditional", 0, (0, 0, 0), 0, 0.0, 1.0),
                               ("fixed", 0, (0, 0, 0))])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        model.add_muscle("m", [(-1, (0, 0, 0)), (0, (0, 0, 0))],
                         wraps=((None, (0,)),))
