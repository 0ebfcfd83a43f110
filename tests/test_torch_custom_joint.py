"""Parity of the port's coordinate functions and custom joints against the
JAX package, float64 on the CPU.

Models: the pin-equivalent custom joint and the spline-coupled knee of
``test_custom_joint.py``, a six-axis custom joint (the free joint: three
body-fixed rotations, then three translations, one of them a polynomial
of its coordinate) behind rotated offset frames; the contact leg of
``test_torch_contact_leg.py`` chains custom and revolute joints. Inputs
are drawn with numpy from a fixed seed; the port evaluates the batch at
once, the JAX package point by point through ``vmap``.

Held: frames, RNEA, the mass matrix, forward dynamics, a station's
velocity and the Hessian of w . RNEA in (q, u) (the second derivatives of
S(q) and its rate, which the port writes in closed form and the JAX
package takes from ``jvp`` of the joint's pose map). Tolerance: relative
1e-12 of the largest magnitude in each compared array (the same formulas
in float64; only the order of a few sums differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models import functions as jfun
from opensim_moco_tpu.utils.splines import CubicSpline as JCubicSpline
from opensim_moco_tpu_torch.convert import params_from_numpy
from opensim_moco_tpu_torch.models import MechModelBuilder as TMechModelBuilder
from opensim_moco_tpu_torch.models import functions as tfun
from opensim_moco_tpu_torch.utils.splines import CubicSpline as TCubicSpline
from test_torch_constrained_common import per_lane

torch.set_num_threads(2)

RTOL = 1e-12
JAX = (JMechModelBuilder, JCubicSpline, jfun.MultivariatePolynomialFunction,
       lambda v: v[None])
PORT = (TMechModelBuilder, TCubicSpline, tfun.MultivariatePolynomialFunction,
        lambda v: v[..., None])


def assert_close(port, ref, rtol=RTOL):
    port = port.detach().numpy()
    ref = np.asarray(ref)
    port = np.broadcast_to(port, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def ident(v):
    return v


def _axes(rot, trans):
    """Six custom axes: rotations about z, x, y and translations along x,
    y, z; ``rot``/``trans`` map an axis position to (fn, local_ci)."""
    dirs = ((0, 0, 1), (1, 0, 0), (0, 1, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))
    spec = list(rot) + list(trans)
    return tuple((d, *(spec[k] or (None, 0))) for k, d in enumerate(dirs))


def pin(pkg):
    B = pkg[0]
    b = B(gravity=(0, -9.81, 0))
    b.add_body("rod", mass=2.1, com=(0, -1.3, 0), kind="custom",
               joint_name="j", coord_names=("theta",),
               custom_axes=_axes([(ident, 0), None, None], [None] * 3))
    return b.finalize()


def _knee_splines(Spline):
    xs = np.linspace(-2.0, 0.2, 12)
    return (Spline(xs, 0.02 * np.sin(xs)),
            Spline(xs, -0.39 + 0.01 * xs ** 2))


def spline_knee(pkg):
    B, Spline = pkg[:2]
    fx, fy = _knee_splines(Spline)
    b = B(gravity=(0, -9.81, 0))
    b.add_body("tibia", mass=3.0, com=(0, -0.2, 0),
               inertia=np.diag([0.05, 0.005, 0.05]), kind="custom",
               joint_name="knee", coord_names=("knee_angle",),
               custom_axes=_axes([(ident, 0), None, None],
                                 [(lambda v: fx(v), 0), (lambda v: fy(v), 0),
                                  None]))
    return b.finalize()


def six_axis(pkg):
    """The free joint, behind rotated offset frames on both sides; its z
    translation is a polynomial 0.1 + 0.5 tz + 0.2 tz^2 of its
    coordinate."""
    B, _, Poly, as_vec = pkg
    poly = Poly([0.1, 0.5, 0.2], 1, 2)
    c, s = np.cos(0.4), np.sin(0.4)
    Rz = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    Rx = np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    b = B(gravity=(0.2, -9.81, 0.1))
    b.add_body("free", mass=1.7, com=(0.05, -0.2, 0.03),
               inertia=np.array([[0.04, 0.002, 0.0], [0.002, 0.02, 0.001],
                                 [0.0, 0.001, 0.05]]),
               kind="custom", joint_name="free",
               coord_names=("rz", "rx", "ry", "tx", "ty", "tz"),
               custom_axes=_axes([(ident, 0), (ident, 1), (ident, 2)],
                                 [(ident, 3), (ident, 4),
                                  (lambda v: poly(as_vec(v)), 5)]),
               tree_E=Rz, tree_r=(0.1, 0.9, 0.0), child_E=Rx,
               child_r=(0.0, 0.05, 0.02))
    return b.finalize()


MODELS = {"pin": pin, "spline_knee": spline_knee, "six_axis": six_axis}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_custom_joint_mechanics_parity(name):
    jm, tm = MODELS[name](JAX), MODELS[name](PORT)
    assert tm.nq == jm.nq and tm.coord_names == jm.coord_names
    pj = jm.default_params()
    pt = params_from_numpy(jax.device_get(pj), "cpu")
    rng = np.random.default_rng(1)
    P = 5
    q = rng.uniform(-1.0, 0.1, (P, jm.nq))
    u, ud, tau = (rng.standard_normal((P, jm.nq)) for _ in range(3))
    T = [torch.as_tensor(a) for a in (q, u, ud, tau)]

    last, loc = tm.nb - 1, (0.03, -0.1, 0.02)

    @per_lane
    def jax_all(q, u, ud, tau):
        return (jm.rnea(pj, q, u, ud), jm.mass_matrix(pj, q),
                jm.forward_dynamics(pj, q, u, tau), jm.frames(pj, q),
                jm.station_velocity(pj, q, u, last, jnp.asarray(loc)))

    rnea, M, fd, frames, vel = jax_all(
        *[jnp.asarray(a) for a in (q, u, ud, tau)])
    # second derivatives through the motion subspace S(q) and its rate:
    # the Hessian of w . rnea in (q, u), forward over reverse
    w = np.random.default_rng(2).standard_normal(jm.nq)

    def wr_j(qu, ud_):
        return jm.rnea(pj, qu[:jm.nq], qu[jm.nq:], ud_) @ jnp.asarray(w)

    H_j = per_lane(jax.hessian(wr_j))(
        jnp.asarray(np.concatenate([q, u], 1)), jnp.asarray(ud))
    wt = torch.as_tensor(w)

    def wr_t(qu, ud_):
        return (tm.rnea(pt, qu[:tm.nq], qu[tm.nq:], ud_) * wt).sum()

    H_t = torch.func.vmap(torch.func.hessian(wr_t))(
        torch.as_tensor(np.concatenate([q, u], 1)), T[2])
    assert_close(H_t, H_j)
    assert_close(tm.rnea(pt, *T[:3]), rnea)
    assert_close(tm.mass_matrix(pt, T[0]), M)
    assert_close(tm.forward_dynamics(pt, T[0], T[1], T[3]), fd)
    for (At, ot), (Aj, oj) in zip(tm.frames(pt, T[0]), frames):
        assert_close(At, Aj)
        assert_close(ot, oj)
    assert_close(tm.station_velocity(pt, T[0], T[1], last, loc), vel)


def test_polynomial_function_parity():
    rng = np.random.default_rng(2)
    for dim, order in ((1, 3), (2, 2), (3, 3), (6, 1)):
        E = jfun._exponent_table(dim, order)
        np.testing.assert_array_equal(tfun._exponent_table(dim, order), E)
        coef = rng.standard_normal(len(E))
        jp = jfun.MultivariatePolynomialFunction(coef, dim, order)
        tp = tfun.MultivariatePolynomialFunction(coef, dim, order)
        assert tp.n_terms == jp.n_terms
        x = rng.uniform(-1.5, 1.5, (7, dim))
        xt = torch.as_tensor(x)
        val, grad = jax.jit(jax.vmap(jax.value_and_grad(jp)))(
            jnp.asarray(x))
        assert_close(tp(xt), val)
        assert_close(torch.func.vmap(torch.func.grad(tp))(xt), grad)
    with pytest.raises(ValueError):
        tfun.MultivariatePolynomialFunction(np.ones(3), 1, 3)
    with pytest.raises(ValueError):
        tfun._exponent_table(7, 1)
