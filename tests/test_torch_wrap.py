"""The port's cylinder wrap (``models/wrap.py``) against the JAX package.

The six cases of ``tests/test_wrap.py`` on the port (a segment that
clears the cylinder, a symmetric wrap against a brute-force tangent
search, wrapped >= straight and continuity at grazing, the helical
length, the quadrant's side, a finite derivative), then ``cylinder_wrap``
(length, engaged, T1, T2) and ``chained_wrap_length`` against the JAX
package on points drawn with numpy from a fixed seed: every quadrant,
near-grazing segments, points inside the circle (the clamps), and the
gradients in P and Q away from the switch surfaces. Tolerance 1e-12 of
the largest magnitude (float64; the same formulas, the same guards).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu.models import wrap as jwrap
from opensim_moco_tpu_torch.models.wrap import (chained_wrap_length,
                                                cylinder_wrap,
                                                cylinder_wrap_length)

RTOL = 1e-12
QUADRANTS = ("all", "+x", "-x", "+y", "-y")


def t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def assert_close(port, ref, rtol=RTOL):
    port = port.detach().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def _norm(v):
    return float(torch.linalg.norm(v))


# ------------------------------------------ tests/test_wrap.py on the port


def test_no_wrap_when_segment_clears_cylinder():
    P = t([-1.0, 0.5, 0.0])
    Q = t([1.0, 0.5, 0.3])
    L = float(cylinder_wrap_length(P, Q, 0.2))
    np.testing.assert_allclose(L, _norm(Q - P), rtol=1e-12)


def _seg_clears(A, B, R):
    """Segment A-B stays outside the circle (allowing tangency)."""
    d = B - A
    s = np.clip(-(A @ d) / max(d @ d, 1e-16), 0.0, 1.0)
    c = A + s * d
    return c @ c >= R ** 2 - 1e-9


def _brute_force_wrap(P2, Q2, R, n=4000):
    """Independent check: minimize |P-T1| + arc + |T2-Q| over circle-point
    pairs, rejecting segments that cut through the circle."""
    phis = np.linspace(-np.pi, np.pi, n, endpoint=False)
    T = np.stack([R * np.cos(phis), R * np.sin(phis)], axis=1)
    dP = np.linalg.norm(T - P2, axis=1)
    dQ = np.linalg.norm(T - Q2, axis=1)
    okP = np.array([_seg_clears(P2, T[i], R) for i in range(n)])
    okQ = np.array([_seg_clears(T[i], Q2, R) for i in range(n)])
    best = np.inf
    for i in range(0, n, 8):
        if not okP[i]:
            continue
        arc = np.abs((phis - phis[i]) % (2 * np.pi))
        arc = np.minimum(arc, 2 * np.pi - arc)
        total = np.where(okQ, dP[i] + R * arc + dQ, np.inf)
        best = min(best, float(np.min(total)))
    return best


def test_symmetric_wrap_vs_brute_force():
    a, h, R = 1.0, 0.2, 0.4
    P = t([-a, -h, 0.0])
    Q = t([a, -h, 0.0])
    L = float(cylinder_wrap_length(P, Q, R))
    assert L > _norm(Q - P)  # the wrap engages
    expected = _brute_force_wrap(np.array([-a, -h]), np.array([a, -h]), R)
    np.testing.assert_allclose(L, expected, rtol=1e-3)


def test_wrap_longer_than_straight_and_continuous():
    R = 0.3
    for h in [0.31, 0.301, 0.2999, 0.29, 0.2]:
        P = t([-1.0, -h, 0.0])
        Q = t([1.0, -h, 0.1])
        assert float(cylinder_wrap_length(P, Q, R)) >= _norm(Q - P) - 1e-12
    P = t([-1.0, -R - 1e-6, 0.0])
    Q = t([1.0, -R - 1e-6, 0.0])
    assert abs(float(cylinder_wrap_length(P, Q, R)) - _norm(Q - P)) < 1e-4


def test_helical_wrap_with_axial_offset():
    a, h, R = 1.0, 0.2, 0.4
    L0 = float(cylinder_wrap_length(t([-a, -h, 0.0]), t([a, -h, 0.0]), R))
    L = float(cylinder_wrap_length(t([-a, -h, 0.0]), t([a, -h, 0.7]), R))
    np.testing.assert_allclose(L, np.sqrt(L0 ** 2 + 0.7 ** 2), rtol=1e-9)


def test_quadrant_selects_wrap_side():
    a, h, R = 1.0, 0.2, 0.4
    P = t([-a, -h, 0.0])
    Q = t([a, -h, 0.0])
    assert float(cylinder_wrap_length(P, Q, R, quadrant="+y")) > \
        float(cylinder_wrap_length(P, Q, R, quadrant="-y"))


def test_differentiable():
    h = t(0.25).requires_grad_()
    L = cylinder_wrap_length(torch.stack([-torch.ones(()), -h, 0 * h]),
                             torch.stack([torch.ones(()), -h, 0.1 + 0 * h]),
                             0.3)
    (g,) = torch.autograd.grad(L, h)
    assert np.isfinite(float(g))


# ------------------------------------------------ against the JAX package


def _points(seed, n=400):
    """P, Q (n, 3) and radii (n,): generic pairs, near-grazing segments
    (the closest point within 1e-7 of the circle) and pairs with one or
    both points inside the circle."""
    rng = np.random.default_rng(seed)
    P = rng.uniform(-1.0, 1.0, (n, 3))
    Q = rng.uniform(-1.0, 1.0, (n, 3))
    R = rng.uniform(0.05, 0.6, n)
    # near grazing: chords at distance R +- 1e-7 from the axis, in random
    # directions (the arc's midpoint off the quadrants' boundaries)
    g = slice(n // 4, n // 2)
    th = rng.uniform(-np.pi, np.pi, n // 4)
    normal = np.stack([np.cos(th), np.sin(th)], 1)
    along = np.stack([-np.sin(th), np.cos(th)], 1)
    foot = (R[g] + rng.choice([-1e-7, 1e-7], n // 4))[:, None] * normal
    P[g, :2] = foot - rng.uniform(0.3, 1.0, (n // 4, 1)) * along
    Q[g, :2] = foot + rng.uniform(0.3, 1.0, (n // 4, 1)) * along
    k = slice(n // 2, 5 * n // 8)  # P inside the circle
    P[k, :2] *= (0.9 * R[k] / np.linalg.norm(P[k, :2], axis=1))[:, None]
    k = slice(5 * n // 8, 3 * n // 4)  # both inside
    P[k, :2] *= (0.5 * R[k] / np.linalg.norm(P[k, :2], axis=1))[:, None]
    Q[k, :2] *= (0.7 * R[k] / np.linalg.norm(Q[k, :2], axis=1))[:, None]
    return P, Q, R


def _jax_wrap(P, Q, R, quadrant):
    return [np.asarray(a) for a in jax.jit(jax.vmap(
        lambda p, q, r: jwrap.cylinder_wrap(p, q, r, quadrant)))(
            jnp.asarray(P), jnp.asarray(Q), jnp.asarray(R))]


@pytest.mark.parametrize("quadrant", QUADRANTS)
def test_cylinder_wrap_against_jax(quadrant):
    P, Q, R = _points(11)
    ref = _jax_wrap(P, Q, R, quadrant)
    # the port takes one radius per call: point by point
    out = [cylinder_wrap(t(P[i]), t(Q[i]), float(R[i]), quadrant)
           for i in range(len(R))]
    port = [torch.stack([o[k] for o in out]) for k in range(4)]
    np.testing.assert_array_equal(port[1].numpy(), ref[1])
    assert ref[1].any() and not ref[1].all()
    for k in (0, 2, 3):
        assert_close(port[k], ref[k])
    # the batched form agrees with the pointwise one
    same = np.full_like(R, 0.3)
    ref = _jax_wrap(P, Q, same, quadrant)
    port = cylinder_wrap(t(P), t(Q), 0.3, quadrant)
    np.testing.assert_array_equal(port[1].numpy(), ref[1])
    for k in (0, 2, 3):
        assert_close(port[k], ref[k])


@pytest.mark.parametrize("quadrant", QUADRANTS)
def test_cylinder_wrap_gradients(quadrant):
    """d length / d(P, Q) at points at least 1e-3 from the switch
    surfaces (grazing, and P or Q on the circle)."""
    P, Q, R = _points(12)
    keep = []
    for i in range(len(R)):
        d = Q[i, :2] - P[i, :2]
        s = np.clip(-(P[i, :2] @ d) / (d @ d), 0.0, 1.0)
        far = min(abs(np.linalg.norm(P[i, :2] + s * d) - R[i]),
                  abs(np.linalg.norm(P[i, :2]) - R[i]),
                  abs(np.linalg.norm(Q[i, :2]) - R[i]))
        if far > 1e-3:
            keep.append(i)
    P, Q, R = P[keep], Q[keep], R[keep]
    gj = jax.jit(jax.vmap(jax.grad(
        lambda p, q, r: jwrap.cylinder_wrap_length(p, q, r, quadrant),
        argnums=(0, 1))))(jnp.asarray(P), jnp.asarray(Q), jnp.asarray(R))
    gp, gq = [], []
    for i in range(len(R)):
        a, b = t(P[i]), t(Q[i])
        gp_, gq_ = torch.func.grad(
            lambda x, y: cylinder_wrap_length(x, y, float(R[i]), quadrant),
            argnums=(0, 1))(a, b)
        gp.append(gp_)
        gq.append(gq_)
    assert_close(torch.stack(gp), gj[0])
    assert_close(torch.stack(gq), gj[1])


def _frames(lib, angle, offset):
    """(to_cyl, from_cyl) of a cylinder frame rotated by ``angle`` about x
    and shifted by ``offset``, for the package whose array module is
    ``lib``."""
    c, s = np.cos(angle), np.sin(angle)
    E = np.array([[1.0, 0, 0], [0, c, -s], [0, s, c]])
    if lib is torch:
        Et, o = t(E), t(offset)
        return (lambda x: (x - o) @ Et.T), (lambda y: y @ Et + o)
    Ej, o = jnp.asarray(E), jnp.asarray(offset)
    return (lambda x: Ej @ (x - o)), (lambda y: Ej.T @ y + o)


def test_chained_wrap_length_against_jax():
    rng = np.random.default_rng(13)
    n = 300
    a = rng.uniform(-1.0, 1.0, (n, 3))
    b = rng.uniform(-1.0, 1.0, (n, 3))
    a[:, 1] += 0.8
    b[:, 1] -= 0.8
    cyls = [(0.1, (0.05, 0.3, 0.0), 0.15, "all"),
            (-0.2, (-0.05, -0.3, 0.1), 0.12, "-x")]

    def jax_chain(k):
        frames = [_frames(jnp, ang, off) + (r, q)
                  for ang, off, r, q in cyls[:k]]
        return np.asarray(jax.vmap(
            lambda x, y: jwrap.chained_wrap_length(x, y, frames))(
                jnp.asarray(a), jnp.asarray(b)))

    for k in (1, 2):
        frames = [_frames(torch, ang, off) + (r, q)
                  for ang, off, r, q in cyls[:k]]
        assert_close(chained_wrap_length(t(a), t(b), frames), jax_chain(k))
    # each of the four engagement cases occurs
    eng = [np.asarray(jax.vmap(lambda x, y, f=_frames(jnp, ang, off), r=r,
                               q=q: jwrap.cylinder_wrap(f[0](x), f[0](y),
                                                        r, q)[1])(
        jnp.asarray(a), jnp.asarray(b))) for ang, off, r, q in cyls]
    cases = {(bool(e1), bool(e2)) for e1, e2 in zip(*eng)}
    assert cases == {(True, True), (True, False), (False, True),
                     (False, False)}
