"""Muscle-path wrapping surfaces: the cylinder wrap.

Counterpart of ``opensim_moco_tpu.models.wrap`` (the obstacle-set method
of Garner and Pandy 2000, the geometry of OpenSim's WrapCylinder). In
the cylinder's cross-section the shortest path from P to Q around the
circle of radius R is tangent-arc-tangent; unrolling the cylinder and
its tangent planes makes the 3D shortest path a straight line of length
``sqrt(L_plane^2 + dz^2)``, with the tangent points' axial coordinates
linear in the developed arc length. The wrap engages only where the
planar segment crosses the circle (or, with a quadrant, passes on the
far side of it); at grazing incidence wrapped and straight lengths
agree, so the switch is continuous.

Every function takes points (..., 3) with any leading dims and is
differentiable under ``torch.func``. The guards are the JAX package's:
the ``1e-12`` clamps under square roots, the clip under ``arccos``, the
``1e-16`` inside ``sign``, ``torch.remainder`` for ``jnp.mod`` (the same
sign rule) and ``torch.where`` with both branches finite, so that the
derivatives at the switch surfaces are the JAX package's.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class WrapCylinderSpec:
    """A cylinder fixed in a body (JAX ``models/wrap.py:34``).
    ``translation``/``xyz_rotation`` give the cylinder frame's pose in the
    body (axis = local z). ``quadrant`` restricts the side the path may
    wrap around (OpenSim WrapObject quadrant: 'all', '+x', '-x', '+y',
    '-y')."""
    name: str
    body: int
    translation: tuple
    xyz_rotation: tuple
    radius: float
    quadrant: str = "all"

    def rotation(self):
        """Body -> cylinder coordinate map E (numpy, static)."""
        rx, ry, rz = self.xyz_rotation
        cx, sx = np.cos(rx), np.sin(rx)
        cy, sy = np.cos(ry), np.sin(ry)
        cz, sz = np.cos(rz), np.sin(rz)
        Rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        return (Rx @ Ry @ Rz).T


_AXIS = {"x": 0, "y": 1}


def _dot(a, b):
    return (a * b).sum(-1)


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _wrap_2d(p, q, R, quadrant_sign, quadrant_axis):
    """Planar tangent-arc-tangent around the circle of radius R, for
    points p, q (..., 2) (JAX ``models/wrap.py:61``).

    Returns (planar_length, engaged, tp, tq, dp, dq, arc): the tangent
    points' angles tp (entry) and tq (exit), the tangent lengths dp/dq
    and the arc angle. ``engaged`` is False where the straight segment
    clears the circle or the wrap would be on the inactive side."""
    rp = torch.sqrt(_dot(p, p))
    rq = torch.sqrt(_dot(q, q))
    # tangent lengths (points inside the circle: clamped)
    dp = torch.sqrt(torch.clamp(rp ** 2 - R ** 2, min=1e-12))
    dq = torch.sqrt(torch.clamp(rq ** 2 - R ** 2, min=1e-12))
    # angles of p, q and the tangent half-angles
    ap = torch.atan2(p[..., 1], p[..., 0])
    aq = torch.atan2(q[..., 1], q[..., 0])
    # R as a tensor: a number divided by a tensor is a reciprocal times
    # the number in PyTorch, one rounding more than the division
    Rt = torch.full_like(rp, R)
    bp = torch.arccos(torch.clamp(Rt / torch.clamp(rp, min=R + 1e-12),
                                  -1.0, 1.0))
    bq = torch.arccos(torch.clamp(Rt / torch.clamp(rq, min=R + 1e-12),
                                  -1.0, 1.0))

    # two tangent-point pairings; for each the arc's direction follows
    # from tangent consistency: the incoming segment's direction at the
    # entry point matches the arc's velocity there
    def candidate(tp, tq):
        Tp = R * torch.stack([torch.cos(tp), torch.sin(tp)], -1)
        d_ccw = torch.stack([-torch.sin(tp), torch.cos(tp)], -1)
        sigma = torch.sign(_dot(Tp - p, d_ccw) + 1e-16)
        arc = torch.remainder(sigma * (tq - tp), 2 * np.pi)
        mid = tp + sigma * 0.5 * arc
        return dp + R * arc + dq, mid, arc

    tp_a, tq_a = ap + bp, aq - bq
    tp_b, tq_b = ap - bp, aq + bq
    len_a, mid_a, arc_a = candidate(tp_a, tq_a)
    len_b, mid_b, arc_b = candidate(tp_b, tq_b)

    if quadrant_axis is None:
        pick_a = len_a < len_b
        engaged_side = None
    else:
        # the pairing whose arc midpoint lies on the active side
        trig = torch.cos if quadrant_axis == 0 else torch.sin
        ok_a = quadrant_sign * trig(mid_a) >= 0
        ok_b = quadrant_sign * trig(mid_b) >= 0
        pick_a = torch.where(ok_a & ok_b, len_a < len_b, ok_a)
        engaged_side = ok_a | ok_b

    planar = torch.where(pick_a, len_a, len_b)
    tp_s = torch.where(pick_a, tp_a, tp_b)
    tq_s = torch.where(pick_a, tq_a, tq_b)
    arc_s = torch.where(pick_a, arc_a, arc_b)

    # does the straight planar segment cross the circle?
    d = q - p
    dd = _dot(d, d)
    tpar = torch.clamp(-_dot(p, d) / torch.clamp(dd, min=1e-16), 0.0, 1.0)
    closest = p + tpar.unsqueeze(-1) * d
    crosses = _dot(closest, closest) < R ** 2
    if quadrant_axis is not None:
        # OpenSim's mandatory far-side wrap (WrapCylinder::wrapLine with
        # _wrapSign): a straight segment on the side opposite the active
        # quadrant still wraps around the quadrant's side
        crosses = crosses | (quadrant_sign * closest[..., quadrant_axis] < 0)
        crosses = crosses & engaged_side
    return planar, crosses, tp_s, tq_s, dp, dq, arc_s


def _quadrant_args(quadrant):
    """(axis, sign) of a quadrant string (JAX ``models/wrap.py:130``)."""
    if quadrant in (None, "all", ""):
        return None, 1.0
    sign = -1.0 if quadrant.startswith("-") else 1.0
    return _AXIS[quadrant.lstrip("+-")], sign


def cylinder_wrap(P, Q, radius, quadrant="all"):
    """Shortest path P -> around the cylinder (axis z through the origin)
    -> Q, for points P, Q (..., 3) in the cylinder frame (JAX
    ``models/wrap.py:137``).

    Returns (length, engaged, T1, T2): T1/T2 (..., 3) are the tangent
    points on the cylinder (z placed by the unrolled development), valid
    where ``engaged``; the length is |PQ| where the wrap does not
    engage."""
    axis, sign = _quadrant_args(quadrant)
    planar, engaged, tp, tq, dp, dq, arc = _wrap_2d(
        P[..., :2], Q[..., :2], radius, sign, axis)
    dz = Q[..., 2] - P[..., 2]
    wrapped = torch.sqrt(planar ** 2 + dz ** 2)
    straight = torch.sqrt(((Q - P) ** 2).sum(-1) + 1e-30)
    # wrapped >= straight holds geometrically; the max guards the
    # near-grazing region where the two agree to rounding
    length = torch.where(engaged, torch.maximum(wrapped, straight), straight)
    # the tangent points' axial placement: linear in developed arc length
    denom = torch.clamp(planar, min=1e-12)
    z1 = P[..., 2] + dz * dp / denom
    z2 = Q[..., 2] - dz * dq / denom
    T1 = torch.stack([radius * torch.cos(tp), radius * torch.sin(tp), z1],
                     -1)
    T2 = torch.stack([radius * torch.cos(tq), radius * torch.sin(tq), z2],
                     -1)
    return length, engaged, T1, T2


def cylinder_wrap_length(P, Q, radius, quadrant="all"):
    """The length of :func:`cylinder_wrap` (JAX ``models/wrap.py:164``)."""
    return cylinder_wrap(P, Q, radius, quadrant)[0]


def chained_wrap_length(a, b, cyl_frames):
    """The segment a -> b (..., 3) over cylinders applied in turn (JAX
    ``models/wrap.py:169``; OpenSim's GeometryPath::applyWrapObjects, with
    an earlier wrap's tangent points as via points of the later ones, as
    med_gas over two cylinders).

    ``cyl_frames``: (to_cyl, from_cyl, radius, quadrant) per cylinder in
    path order (proximal first). One cylinder, or two; the total length
    a -> b."""
    straight = _norm(b - a + 1e-30)
    if len(cyl_frames) == 1:
        to_c, _, R, quad = cyl_frames[0]
        return cylinder_wrap(to_c(a), to_c(b), R, quad)[0]
    # each wrap on (a, b) alone, then the engaged ones chained
    results = []
    for to_c, from_c, R, quad in cyl_frames:
        L, e, T1, T2 = cylinder_wrap(to_c(a), to_c(b), R, quad)
        T1w, T2w = from_c(T1), from_c(T2)
        arc = L - _norm(T1w - a + 1e-30) - _norm(b - T2w + 1e-30)
        results.append((L, e, T1w, T2w, torch.clamp(arc, min=0.0)))
    # the two-cylinder chain, the first cylinder proximal (nearer a)
    (L1, e1, T1a, T1b, arc1), (L2, e2, T2a, T2b, arc2) = results
    chain = (_norm(T1a - a + 1e-30) + arc1 + _norm(T2a - T1b + 1e-30) +
             arc2 + _norm(b - T2b + 1e-30))
    return torch.where(e1 & e2, torch.maximum(chain, straight),
                       torch.where(e1, L1, torch.where(e2, L2, straight)))
