"""Minimal-coordinate multibody mechanics in PyTorch.

Counterpart of ``opensim_moco_tpu.models.mech``: Featherstone's RNEA and
CRBA over a static kinematic tree. Topology (parents, joint kinds, axes)
is host-side Python/numpy; everything numeric lives in the parameter dict
from :meth:`MechModel.default_params`.

All dynamics functions take ``q``, ``u``, ``udot`` with arbitrary leading
dimensions (grid points, lanes) and are written without in-place writes,
so ``torch.func.jvp``, ``vjp``, ``jacfwd`` and ``vmap`` apply to them.

Joint kinds: revolute, prismatic, weld and custom (OpenSim CustomJoint:
three body-fixed rotations then a translation, each axis driven by a
function of one of the joint's coordinates). A custom joint's motion
subspace S(q) and its rate are written in closed form from the axis
functions' values and derivatives (the JAX package differentiates the
joint's pose map), so spline-coupled axes work exactly. As in the JAX
package there is no separate free-joint kind: a free joint is a custom
joint with six driven axes.

Forward-mode derivatives run every operation between a constant and a
differentiated tensor through a slow path in PyTorch (a zero tangent
whose shape is worked out in Python), so the custom joints, the
rotations and the body velocities here avoid such operations where they
can: the solver's derivative passes differentiate all of this again.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..convert import params_from_numpy
from .spatial import (block2x2, crf, crm, cross, mv, rodrigues, skew,
                      spatial_inertia, xform)

GROUND = -1

_VALID_KINDS = ("revolute", "prismatic", "weld", "custom")


@dataclasses.dataclass(frozen=True)
class JointSpec:
    """Static description of a joint connecting parent body -> child
    body.

    ``kind == "custom"``: ``custom_axes`` holds six (axis, fn, local_ci)
    tuples, rotations first; ``fn`` maps a tensor of the joint's local
    coordinate ``local_ci`` elementwise (None: the axis is unused)."""

    name: str
    kind: str
    axis: tuple  # unit axis, static (simple joints)
    coord_name: str | None  # None for weld; the first coord for custom
    label: str | None = None  # display name for paths
    coord_names: tuple = ()  # all coords (custom joints)
    custom_axes: tuple = ()  # ((axis3, fn, local_ci) x 6)


@dataclasses.dataclass(frozen=True)
class BodySpec:
    name: str
    mass: float
    com: tuple
    inertia: tuple  # 3x3 nested tuple


@dataclasses.dataclass(frozen=True)
class StationSpec:
    """A point fixed in a body (marker / muscle via point)."""

    name: str
    body: int  # body index, or GROUND
    location: tuple  # in body frame


def spd_solve(M, b):
    """Solve ``M x = b`` for symmetric positive-definite ``M`` (..., k, k).

    Cholesky, because ``torch.func.vmap`` over ``jacfwd`` of the LU-based
    ``torch.linalg.solve`` returns wrong derivatives (torch 2.13); the
    Cholesky path agrees with per-lane evaluation. ``cholesky_ex`` does not
    check for failure, so no host synchronisation happens here."""
    L = torch.linalg.cholesky_ex(M)[0]
    return torch.cholesky_solve(b.unsqueeze(-1), L).squeeze(-1)


def _axis_derivatives(fn, x, order):
    """(fn(x), fn'(x), fn''(x)) of a custom joint's axis function, the
    derivatives up to ``order`` (None beyond it): from the function's own
    ``derivative``/``second_derivative`` methods where it has them
    (``utils.splines.CubicSpline`` does), else by forward-mode autodiff."""
    value = fn(x)
    if order < 1:
        return value, None, None
    if hasattr(fn, "derivative") and hasattr(fn, "second_derivative"):
        return (value, fn.derivative(x),
                fn.second_derivative(x) if order > 1 else None)
    ones = torch.ones_like(x)

    def d1(xx):
        return torch.func.jvp(fn, (xx,), (ones,))[1]

    if order < 2:
        return value, d1(x), None
    first, second = torch.func.jvp(d1, (x,), (ones,))
    return value, first, second


def _scale(x, k):
    """``x * k`` for a tensor or number ``x`` and a tensor or number ``k``;
    None for a factor of 0, and no operation for +-1 (an operation between
    a constant and a differentiated tensor is costly under forward-mode
    transforms)."""
    if x is None:
        return None
    if not torch.is_tensor(k):
        if k == 0.0:
            return None
        if k == 1.0:
            return x
        if k == -1.0:
            return -x
        return x * float(k)
    return k * x


def _vec_scale(v, s, like):
    """A vector (a static tuple of 3 numbers or a tensor (..., 3)) times a
    scalar (a number or a tensor (...)); None when it is zero."""
    if s is None:
        return None
    if not torch.is_tensor(v):
        if not torch.is_tensor(s):
            return _const_vec(tuple(float(a) * s for a in v), like)
        parts = [_scale(s, a) for a in v]
        if all(x is None for x in parts):
            return None
        return torch.stack([torch.zeros_like(s) if x is None else x
                            for x in parts], -1)
    return _scale(v, s) if not torch.is_tensor(s) else v * s.unsqueeze(-1)


def _sum(terms):
    """The sum of the terms that are not None; None if all are."""
    total = None
    for x in terms:
        if x is not None:
            total = x if total is None else total + x
    return total


class BodyKinematics(NamedTuple):
    """One body's part of :meth:`MechModel.kinematics`."""
    X: torch.Tensor  # motion transform parent -> body (..., 6, 6)
    cols: list  # motion subspace: (coordinate, S column (..., 6))
    vJ: torch.Tensor | None  # joint velocity S u
    cJ: torch.Tensor | None  # Sdot u (custom joints)
    A: torch.Tensor  # world -> body rotation (..., 3, 3)
    o: torch.Tensor  # body origin in world coordinates (..., 3)
    v: torch.Tensor | None  # spatial velocity in body coordinates
    I: torch.Tensor  # spatial inertia about the body origin (6, 6)


def _const_vec(values, like):
    """Tensor of static numbers with ``like``'s dtype and device, built by
    fill kernels (no host-to-device copy)."""
    return torch.stack([like.new_full((), float(v)) for v in values])


class MechModel:
    """Immutable kinematic tree; construct via :class:`MechModelBuilder`."""

    def __init__(self, bodies: Sequence[BodySpec], joints: Sequence[JointSpec],
                 parents: Sequence[int], tree_E: np.ndarray, tree_r: np.ndarray,
                 gravity: np.ndarray, child_E: np.ndarray | None = None,
                 child_r: np.ndarray | None = None):
        self.bodies = tuple(bodies)
        self.joints = tuple(joints)
        self.parents = tuple(parents)
        self._tree_E = np.asarray(tree_E, dtype=np.float64)
        self._tree_r = np.asarray(tree_r, dtype=np.float64)
        nb = len(self.bodies)
        self._child_E = (np.tile(np.eye(3), (nb, 1, 1)) if child_E is None
                         else np.asarray(child_E, dtype=np.float64))
        self._child_r = (np.zeros((nb, 3)) if child_r is None
                         else np.asarray(child_r, dtype=np.float64))
        self._gravity = np.asarray(gravity, dtype=np.float64)
        self.coord_names = []
        coords = []
        k = 0
        for j in self.joints:
            if j.kind == "weld":
                coords.append(())
            elif j.kind == "custom":
                coords.append(tuple(range(k, k + len(j.coord_names))))
                self.coord_names.extend(j.coord_names)
                k += len(j.coord_names)
            else:
                coords.append((k,))
                self.coord_names.append(j.coord_name)
                k += 1
        self._coords_of_body = tuple(coords)
        # the first coordinate per body (-1 for a weld)
        self._coord_of_body = tuple(c[0] if c else -1 for c in coords)
        self.nq = k
        self.nb = nb

    # ---------------------------------------------------------------- params
    def numpy_params(self) -> dict:
        """Parameter tree as numpy arrays: every numeric quantity of the
        model, with the keys of the JAX package's ``default_params``."""
        return {
            "mass": np.asarray([b.mass for b in self.bodies]),
            "com": np.asarray([b.com for b in self.bodies]),
            "inertia": np.asarray([b.inertia for b in self.bodies]),
            "tree_E": self._tree_E.copy(),
            "tree_r": self._tree_r.copy(),
            "child_E": self._child_E.copy(),
            "child_r": self._child_r.copy(),
            "gravity": self._gravity.copy(),
        }

    def default_params(self, device, dtype=torch.float64) -> dict:
        """Parameter dict of tensors on ``device``."""
        return params_from_numpy(self.numpy_params(), device, dtype)

    # ------------------------------------------------------------ kinematics
    @staticmethod
    def _custom_parts(spec, qj, order=0):
        """A custom joint at its local coordinates qj (..., d): ``rots`` and
        ``trans``, the used rotation and translation axes as (axis, local
        coordinate, fn, fn', fn'') with the derivatives up to ``order``;
        the rotation matrices ``Rs``; and the joint transform (E_j, r_j):
        body-fixed rotations about the listed axes (OpenSim
        SpatialTransform rotation1..3), then a translation along the listed
        axes in the joint-base frame (translation1..3) (JAX
        ``models/mech.py:164``)."""
        rots, trans = [], []
        for k, (axis, fn, ci) in enumerate(spec.custom_axes):
            if fn is not None:
                (rots if k < 3 else trans).append(
                    (axis, ci) + _axis_derivatives(fn, qj[..., ci], order))
        Rs = [rodrigues(axis, th) for axis, _, th, _, _ in rots]
        R = None
        for Ra in Rs:
            R = Ra if R is None else R @ Ra
        E_j = (torch.diag_embed(_const_vec((1.0, 1.0, 1.0), qj))
               if R is None else R.transpose(-1, -2))
        t = _sum(_vec_scale(axis, tau, qj) for axis, _, tau, _, _ in trans)
        if t is None:
            t = qj.new_zeros(qj.shape[:-1] + (3,))
        return rots, trans, Rs, E_j, t

    def _offsets(self, i, p, E_j, r_j):
        """Parent offset frame -> joint transform (E_j, r_j) -> inverse child
        offset frame: the net parent-body -> child-body map."""
        E_T = p["tree_E"][i]
        r_T = p["tree_r"][i]
        cE = p["child_E"][i]
        cr = p["child_r"][i]
        E, r = E_j @ E_T, r_T + mv(E_T.transpose(-1, -2), r_j)
        r = r + mv(E.transpose(-1, -2), -mv(cE, cr))
        return cE.transpose(-1, -2) @ E, r

    def _joint_coords(self, i, q):
        idxs = self._coords_of_body[i]
        return q[..., idxs[0]:idxs[-1] + 1]

    def _joint_net(self, i, p, q):
        """Net (E, r) parent-body -> child-body map and the motion subspace
        S (6,) in child coordinates (None for a weld and for a custom
        joint, whose S depends on q: see :meth:`_body_motion`).

        Chain: parent offset frame -> joint transform -> inverse child
        offset frame, as in the JAX package."""
        spec = self.joints[i]
        if spec.kind == "custom":
            E, r = self._offsets(i, p, *self._custom_parts(
                spec, self._joint_coords(i, q))[3:])
            return E, r, None
        ci = self._coord_of_body[i]
        cE = p["child_E"][i]
        cr = p["child_r"][i]
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        if spec.kind == "revolute":
            E_j = rodrigues(spec.axis, q[..., ci]).transpose(-1, -2)
            r_j = q.new_zeros(q.shape[:-1] + (3,))
            s_coef = tuple(spec.axis) + (0.0, 0.0, 0.0)
        elif spec.kind == "prismatic":
            E_j = eye
            r_j = torch.stack([q[..., ci] * float(a) for a in spec.axis], -1)
            s_coef = (0.0, 0.0, 0.0) + tuple(spec.axis)
        else:  # weld
            E_j = eye
            r_j = q.new_zeros(3)
            s_coef = None
        E, r = self._offsets(i, p, E_j, r_j)
        if s_coef is None:
            return E, r, None
        cEt = cE.transpose(-1, -2)
        Z = torch.zeros_like(cE)
        Xc = block2x2(cEt, Z, -cEt @ skew(-mv(cE, cr)), cEt)
        S = sum(Xc[..., :, k] * float(c) for k, c in enumerate(s_coef)
                if c != 0.0)
        return E, r, S

    def _body_motion(self, i, p, q, u=None, rates=False, subspace=True):
        """(E, r, cols, vJ, cJ) of body i: the net parent-body ->
        child-body map (E, r), ``cols`` the motion subspace as (coordinate,
        S column (..., 6)) pairs, the joint velocity vJ = S u (None without
        ``u``) and, with ``rates``, cJ = Sdot u, the joint acceleration at
        zero coordinate accelerations (None where it is zero: simple
        joints). Custom joints: :meth:`_custom_motion`, which leaves
        ``cols`` empty without ``subspace``."""
        if self.joints[i].kind == "custom":
            return self._custom_motion(i, p, q, u, rates, subspace)
        E, r, S = self._joint_net(i, p, q)
        if S is None:
            return E, r, [], None, None
        ci = self._coord_of_body[i]
        vJ = None if u is None else S * u[..., ci, None]
        return E, r, [(ci, S)], vJ, None

    def _custom_motion(self, i, p, q, u=None, rates=False, subspace=True):
        """:meth:`_body_motion` of custom joint i in closed form.

        The JAX package takes S, vJ and aJ from ``jvp``/``jacfwd`` of the
        joint's pose map (``models/mech.py:314-338``); here the same
        quantities come from the axis functions' values and derivatives
        (their ``derivative``/``second_derivative`` methods where they have
        them, else forward-mode autodiff). With R = R_1 R_2 R_3 the
        rotations, b_k = (R_{k+1} ... R_3)^T a_k, t the translation,
        c = child_E child_r and C = child_E^T:

        - omega_R = sum_k theta_k' u b_k (the body angular velocity of R),
          vJ = [C omega_R; C (R^T tdot - omega_R x c)];
        - at zero coordinate accelerations (the rest of aJ is S udot),
          omega_R' = sum_k theta_k'' u^2 b_k
          + theta_k' u b_k x sum_{j>k} theta_j' u b_j,
          cJ = [C omega_R'; C (R^T tddot - omega_R x R^T tdot
          - omega_R' x c)] with tddot = sum_k tau_k'' u^2 a_k;

        the columns of S are vJ at unit coordinate rates."""
        qj = self._joint_coords(i, q)
        rots, trans, Rs, Rt, t = self._custom_parts(
            self.joints[i], qj, 2 if rates else 1)
        # b_k = (R_{k+1} ... R_3)^T a_k, from the last rotation back (the
        # last one's is its static axis)
        bs, M = [None] * len(rots), None
        for k in reversed(range(len(rots))):
            axis = rots[k][0]
            bs[k] = axis if M is None else _sum(
                _scale(M[..., j, :], a) for j, a in enumerate(axis))
            M = Rs[k] if M is None else Rs[k] @ M
        zero3 = torch.zeros_like(t)
        E, r = self._offsets(i, p, Rt, t)
        cE = p["child_E"][i]
        C = cE.transpose(-1, -2)
        c = mv(cE, p["child_r"][i])

        def velocity(rates):
            """(omega_R, R^T tdot) at the coordinate rates ``rates`` (one
            tensor or number per coordinate)."""
            om = _sum(_vec_scale(b, _scale(rates[ci], d1), qj)
                      for b, (_, ci, _, d1, _) in zip(bs, rots))
            td = _sum(_vec_scale(axis, _scale(rates[ci], d1), qj)
                      for axis, ci, _, d1, _ in trans)
            om = zero3 if om is None else om
            return om, zero3 if td is None else mv(Rt, td)

        def spatial(om, lin):
            return torch.cat(torch.broadcast_tensors(mv(C, om), mv(C, lin)),
                             -1)

        def joint_velocity(rates):
            om, Rtd = velocity(rates)
            return om, Rtd, spatial(om, Rtd - torch.linalg.cross(
                om, c.expand_as(om)))

        d = qj.shape[-1]
        cols = [(cidx, joint_velocity([float(j == k) for j in range(d)])[2])
                for k, cidx in enumerate(self._coords_of_body[i])
                if subspace]
        if u is None:
            return E, r, cols, None, None
        uj = self._joint_coords(i, u)
        om, Rtd, vJ = joint_velocity([uj[..., j] for j in range(d)])
        if not rates:
            return E, r, cols, vJ, None

        def accel(ci, d2):
            return _scale(uj[..., ci] ** 2, d2)

        # the rates of omega_R and R^T tdot at zero coordinate accelerations
        rate_b = [_vec_scale(b, _scale(uj[..., ci], d1), qj)
                  for b, (_, ci, _, d1, _) in zip(bs, rots)]
        omd = _sum(_vec_scale(b, accel(ci, d2), qj)
                   for b, (_, ci, _, _, d2) in zip(bs, rots))
        for k in range(len(rots)):
            later = _sum(rate_b[k + 1:])
            if rate_b[k] is not None and later is not None:
                omd = _sum((omd, torch.linalg.cross(rate_b[k], later)))
        tdd = _sum(_vec_scale(axis, accel(ci, d2), qj)
                   for axis, ci, _, _, d2 in trans)
        omd = zero3 if omd is None else omd
        lin = -torch.linalg.cross(om, Rtd) - torch.linalg.cross(
            omd, c.expand_as(omd))
        if tdd is not None:
            lin = lin + mv(Rt, tdd)
        return E, r, cols, vJ, spatial(omd, lin)

    def frames(self, p, q):
        """World pose per body: list of (A, o) with A = E_{body<-world},
        o = body origin in world coordinates."""
        out = []
        for i in range(self.nb):
            E_ip, r_ip, _ = self._joint_net(i, p, q)
            pa = self.parents[i]
            if pa == GROUND:
                A, o = E_ip, r_ip
            else:
                A_p, o_p = out[pa]
                A = E_ip @ A_p
                o = o_p + mv(A_p.transpose(-1, -2), r_ip)
            out.append((A, o))
        return out

    @staticmethod
    def _station_world(frames, body, location, like):
        """World position of ``location`` (three numbers, or a tensor
        (..., 3)) fixed in ``body``."""
        loc = (location if torch.is_tensor(location)
               else _const_vec(location, like))
        if body == GROUND:
            return loc
        A, o = frames[body]
        return o + mv(A.transpose(-1, -2), loc)

    def station_position(self, p, q, body: int, location):
        """World position of a point fixed in ``body`` (GROUND allowed)."""
        if body == GROUND:
            return _const_vec(location, q)
        return self._station_world(self.frames(p, q), body, location, q)

    def station_positions(self, p, q, stations: Sequence[StationSpec]):
        """Stack world positions for many stations (one FK pass)."""
        frames = self.frames(p, q)
        pts = [self._station_world(frames, s.body, s.location, q)
               for s in stations]
        return torch.stack(torch.broadcast_tensors(q[..., :1], *pts)[1:], -2)

    def kinematics(self, p, q, u=None, rates=False, subspace=True):
        """One pass over the tree: per body a :class:`BodyKinematics`, the
        joint's motion transform X, motion subspace and joint velocity and
        rate terms (:meth:`_body_motion`), the world pose, the spatial
        velocity [omega; v] in body coordinates (None where zero) and the
        spatial inertia. The dynamics below take it, so that one evaluation of the
        multibody equations visits each joint once. Without ``subspace``
        (poses and velocities only) a custom joint's ``cols`` stay
        empty."""
        out = []
        for i in range(self.nb):
            E, r, cols, vJ, cJ = self._body_motion(i, p, q, u, rates,
                                                   subspace)
            X = xform(E, r)
            pa = self.parents[i]
            if pa == GROUND:
                A, o, v = E, r, vJ
            else:
                par = out[pa]
                A = E @ par.A
                o = par.o + mv(par.A.transpose(-1, -2), r)
                v = _sum((None if par.v is None else mv(X, par.v), vJ))
            out.append(BodyKinematics(X, cols, vJ, cJ, A, o, v,
                                      self._inertia(p, i)))
        return out

    @staticmethod
    def _station_world_velocity(frames, vels, body, location, like):
        """World position and velocity of ``location`` (three numbers, or a
        tensor (..., 3)) fixed in ``body``, from the poses (A, o) and the
        spatial velocities of :meth:`kinematics`."""
        loc = (location if torch.is_tensor(location)
               else _const_vec(location, like))
        if body == GROUND:
            return loc, torch.zeros_like(loc)
        A, o = frames[body]
        At = A.transpose(-1, -2)
        pos = o + mv(At, loc)
        v = vels[body]
        if v is None:  # welded to the ground
            return pos, torch.zeros_like(pos)
        lin = v[..., 3:] + torch.linalg.cross(
            v[..., :3], loc.expand(v.shape[:-1] + (3,)))
        return pos, mv(At, lin)

    def station_velocity(self, p, q, u, body: int, location):
        """World-frame velocity of a point fixed in ``body``: ``jvp`` of its
        position (JAX ``models/mech.py:308``)."""
        return torch.func.jvp(
            lambda qq: self.station_position(p, qq, body, location), (q,),
            (u,))[1]

    def mass_center(self, p, q):
        """System center of mass in world coordinates."""
        frames = self.frames(p, q)
        total = q.new_zeros(())
        com = q.new_zeros(3)
        for i in range(self.nb):
            mi = p["mass"][i]
            A, o = frames[i]
            com = com + mi * (o + mv(A.transpose(-1, -2), p["com"][i]))
            total = total + mi
        return com / torch.clamp(total, min=1e-12)

    # -------------------------------------------------------------- dynamics
    def _inertia(self, p, i):
        return spatial_inertia(p["mass"][i], p["com"][i], p["inertia"][i])

    def rnea(self, p, q, u, udot, kin=None):
        """Inverse dynamics: generalized forces balancing (q, u, udot) under
        gravity and velocity-product terms (Featherstone RBDA table 5.1,
        generalized to multi-dof joints with q-dependent motion
        subspaces). ``udot`` None means zero; ``kin`` is
        :meth:`kinematics` at (q, u) with ``rates``, made here if
        absent."""
        if kin is None:
            kin = self.kinematics(p, q, u, rates=True)
        return self._project(kin, self._body_forces(p, q, udot, kin), q, u,
                             udot)

    def _body_forces(self, p, q, udot, kin):
        """RNEA's forward pass: per body the spatial force (body
        coordinates, about its origin) its motion needs, gravity included
        as the base's fictitious acceleration."""
        a_base = torch.cat([q.new_zeros(3), -p["gravity"]])
        a, f = [], []
        for i, b in enumerate(kin):
            pa = self.parents[i]
            a_i = mv(b.X, a_base if pa == GROUND else a[pa])
            if b.cols:
                if udot is not None:
                    a_i = a_i + _sum(S * udot[..., c, None]
                                     for c, S in b.cols)
                if b.cJ is not None:
                    a_i = a_i + b.cJ
                a_i = a_i + mv(crm(b.v), b.vJ)
            f_i = mv(b.I, a_i)
            if b.v is not None:
                f_i = f_i + mv(crf(b.v), mv(b.I, b.v))
            a.append(a_i)
            f.append(f_i)
        return f

    def joint_reaction_wrenches(self, p, q, u, udot,
                                body_wrenches_world=None):
        """(..., nb, 6) reaction each joint transmits to its child body,
        [moment; force] in the world, the moment about the joint's
        child-frame origin (Simbody's calcReactionOnChildExpressedInGround,
        which MocoJointReactionGoal reads; JAX ``models/mech.py:430``).
        RNEA's backward pass on one pass over the tree: the force across
        joint i balances the dynamics of the subtree at body i less the
        applied body wrenches ``body_wrenches_world`` (..., nb, 6), world
        wrenches about the body origins. Gravity enters through the base's
        fictitious acceleration."""
        kin = self.kinematics(p, q, u, rates=True)
        f = self._body_forces(p, q, udot, kin)
        if body_wrenches_world is not None:
            for i, b in enumerate(kin):
                Wi = body_wrenches_world[..., i, :]
                f[i] = f[i] - torch.cat([mv(b.A, Wi[..., :3]),
                                         mv(b.A, Wi[..., 3:])], -1)
        for i in reversed(range(self.nb)):
            pa = self.parents[i]
            if pa != GROUND:
                f[pa] = f[pa] + mv(kin[i].X.transpose(-1, -2), f[i])
        out = []
        for i, b in enumerate(kin):
            At = b.A.transpose(-1, -2)
            n_w = mv(At, f[i][..., :3])
            fl_w = mv(At, f[i][..., 3:])
            # the moment from the body origin to the joint's child-frame
            # origin: m_X = m_O - (X - O) x F, X - O = A^T child_r
            r_w = mv(At, _const_vec(self._child_r[i], q))
            n_w = n_w - torch.linalg.cross(*torch.broadcast_tensors(r_w,
                                                                    fl_w))
            out.append(torch.cat(torch.broadcast_tensors(n_w, fl_w), -1))
        return torch.stack(torch.broadcast_tensors(*out), -2)

    def _project(self, kin, f, q, *like):
        """The backward pass: generalized forces tau_c = S_c . f_i from the
        spatial forces ``f`` (body coordinates, about the body origin;
        None for none) on each body, each carried to its parent through
        X^T. Entries that depend on none of the inputs broadcast to
        their shape."""
        f = list(f)
        tau = [None] * self.nq
        for i in reversed(range(self.nb)):
            if f[i] is None:
                continue
            for c, S in kin[i].cols:
                tau[c] = (S * f[i]).sum(-1)
            pa = self.parents[i]
            if pa != GROUND:
                Xt_f = mv(kin[i].X.transpose(-1, -2), f[i])
                f[pa] = Xt_f if f[pa] is None else f[pa] + Xt_f
        if not tau:
            return q.new_zeros(q.shape[:-1] + (0,))
        tau = [torch.zeros_like(q[..., 0]) if t is None else t for t in tau]
        lead = [x[..., 0] for x in (q,) + like if x is not None]
        return torch.stack(torch.broadcast_tensors(*lead, *tau)[len(lead):],
                           -1)

    def point_forces_to_generalized(self, kin, q, forces, moments=()):
        """tau = J^T F for world forces at points fixed in bodies:
        ``forces`` a list of (body, body-local point (..., 3), world force
        (..., 3)); the same generalized forces as the ``vjp`` of the points'
        positions (JAX ``models/model.py:935``). ``moments``: (body, world
        torque (..., 3)) pairs, pure moments on the bodies (the JAX
        package's grad of omega . T)."""
        f = [None] * self.nb

        def put(body, w):
            f[body] = w if f[body] is None else f[body] + w

        for body, loc, F in forces:
            if body == GROUND:
                continue
            Fb = mv(kin[body].A, F)
            put(body, torch.cat(torch.broadcast_tensors(cross(loc, Fb), Fb),
                                -1))
        for body, T in moments:
            Tb = mv(kin[body].A, T)
            put(body, torch.cat([Tb, torch.zeros_like(Tb)], -1))
        return self._project(kin, f, q)

    def bias_forces(self, p, q, u, kin=None):
        """C(q,u) + gravity terms: rnea with zero acceleration."""
        return self.rnea(p, q, u, None, kin)

    def mass_matrix(self, p, q, kin=None):
        """Joint-space inertia matrix via the composite-rigid-body
        algorithm, generalized to multi-dof joints; ``kin`` is
        :meth:`kinematics` at q, made here if absent."""
        if kin is None:
            kin = self.kinematics(p, q)
        Ic = [b.I for b in kin]
        for i in reversed(range(self.nb)):
            pa = self.parents[i]
            if pa != GROUND:
                X = kin[i].X
                Ic[pa] = Ic[pa] + X.transpose(-1, -2) @ Ic[i] @ X
        nq = self.nq
        if nq == 0:
            return q.new_zeros(q.shape[:-1] + (0, 0))
        H = [[q.new_zeros(()) for _ in range(nq)] for _ in range(nq)]
        for i in range(self.nb):
            for ci, S in kin[i].cols:
                F = mv(Ic[i], S)
                for cj, Sj in kin[i].cols:
                    H[cj][ci] = (Sj * F).sum(-1)
                j = i
                while self.parents[j] != GROUND:
                    F = mv(kin[j].X.transpose(-1, -2), F)
                    j = self.parents[j]
                    for cj, Sj in kin[j].cols:
                        B = (Sj * F).sum(-1)
                        H[cj][ci] = B
                        H[ci][cj] = B
        flat = torch.broadcast_tensors(q[..., 0],
                                       *[h for row in H for h in row])[1:]
        return torch.stack(flat, -1).reshape(q.shape[:-1] + (nq, nq))

    def forward_dynamics(self, p, q, u, tau_applied):
        """udot = M(q)^{-1} (tau_applied - bias(q, u))."""
        kin = self.kinematics(p, q, u, rates=True)
        M = self.mass_matrix(p, q, kin)
        b = self.bias_forces(p, q, u, kin)
        return spd_solve(M, tau_applied - b)


class MechModelBuilder:
    """Imperative builder with the JAX package's ``add_body`` signature."""

    def __init__(self, gravity=(0.0, -9.80665, 0.0)):
        self._bodies: list[BodySpec] = []
        self._joints: list[JointSpec] = []
        self._parents: list[int] = []
        self._tree_E: list[np.ndarray] = []
        self._tree_r: list[np.ndarray] = []
        self._child_E: list[np.ndarray] = []
        self._child_r: list[np.ndarray] = []
        self._name_to_idx: dict[str, int] = {"ground": GROUND}
        self._gravity = np.asarray(gravity, dtype=np.float64)

    def add_body(self, name, mass=0.0, com=(0, 0, 0), inertia=None,
                 joint_name=None, kind="weld", parent="ground", axis=(0, 0, 1),
                 tree_r=(0, 0, 0), tree_E=None, coord_name=None,
                 child_r=(0, 0, 0), child_E=None, joint_label=None,
                 coord_names=(), custom_axes=()):
        """Add a body and the joint that connects it to ``parent``.

        ``tree_r``/``tree_E`` give the joint frame pose in the parent frame;
        ``child_r``/``child_E`` its pose in the child frame. A custom joint
        takes its coordinates' names in ``coord_names`` and its
        (axis, fn, local_ci) tuples, rotations first, in ``custom_axes``
        (see :class:`JointSpec`)."""
        if kind not in _VALID_KINDS:
            raise ValueError(f"unknown joint kind {kind!r}")
        if kind == "custom":
            if not coord_names or not custom_axes:
                raise ValueError("custom joints need coord_names and "
                                 "custom_axes")
            for (_, fn, ci) in custom_axes:
                if fn is not None and not 0 <= ci < len(coord_names):
                    raise ValueError(f"custom axis coordinate {ci} is not "
                                     f"one of {len(coord_names)}")
            coord_name = coord_names[0]
            custom_axes = tuple((tuple(float(a) for a in ax), fn, int(ci))
                                for (ax, fn, ci) in custom_axes)
        if inertia is None:
            inertia = np.zeros((3, 3))
        inertia = np.asarray(inertia, dtype=np.float64)
        if inertia.shape == (3,):
            inertia = np.diag(inertia)
        if tree_E is None:
            tree_E = np.eye(3)
        if child_E is None:
            child_E = np.eye(3)
        if joint_name is None:
            joint_name = f"{name}_joint"
        if kind != "weld" and coord_name is None:
            coord_name = f"{joint_name}_coord"
        ax = np.asarray(axis, dtype=np.float64)
        if kind not in ("weld", "custom"):
            ax = ax / np.linalg.norm(ax)
        self._bodies.append(BodySpec(name, float(mass),
                                     tuple(np.asarray(com, dtype=np.float64)),
                                     tuple(map(tuple, inertia))))
        self._joints.append(JointSpec(joint_name, kind,
                                      tuple(float(a) for a in ax),
                                      coord_name, joint_label or joint_name,
                                      tuple(coord_names),
                                      tuple(custom_axes)))
        self._parents.append(self._name_to_idx[parent])
        self._tree_E.append(np.asarray(tree_E, dtype=np.float64))
        self._tree_r.append(np.asarray(tree_r, dtype=np.float64))
        self._child_E.append(np.asarray(child_E, dtype=np.float64))
        self._child_r.append(np.asarray(child_r, dtype=np.float64))
        self._name_to_idx[name] = len(self._bodies) - 1
        return self._name_to_idx[name]

    def body_index(self, name: str) -> int:
        return self._name_to_idx[name]

    def finalize(self) -> MechModel:
        return MechModel(self._bodies, self._joints, self._parents,
                         np.stack(self._tree_E), np.stack(self._tree_r),
                         self._gravity, np.stack(self._child_E),
                         np.stack(self._child_r))
