"""Minimal-coordinate multibody mechanics in PyTorch.

Counterpart of ``opensim_moco_tpu.models.mech``: Featherstone's RNEA and
CRBA over a static kinematic tree. Topology (parents, joint kinds, axes)
is host-side Python/numpy; everything numeric lives in the parameter dict
from :meth:`MechModel.default_params`.

All dynamics functions take ``q``, ``u``, ``udot`` with arbitrary leading
dimensions (grid points, lanes) and are written without in-place writes,
so ``torch.func.jvp``, ``vjp``, ``jacfwd`` and ``vmap`` apply to them.

Joint kinds: revolute, prismatic and weld. Custom joints (OpenSim
CustomJoint) and free joints are not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..convert import params_from_numpy
from .spatial import (block2x2, crf, crm, mv, rodrigues, skew,
                      spatial_inertia)

GROUND = -1

_VALID_KINDS = ("revolute", "prismatic", "weld")
_UNPORTED_KINDS = ("custom", "free")


@dataclasses.dataclass(frozen=True)
class JointSpec:
    """Static description of a joint connecting parent body -> child
    body."""

    name: str
    kind: str
    axis: tuple  # unit axis, static
    coord_name: str | None  # None for weld
    label: str | None = None  # display name for paths


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
        coord_of_body = []
        k = 0
        for j in self.joints:
            if j.kind == "weld":
                coord_of_body.append(-1)
            else:
                coord_of_body.append(k)
                self.coord_names.append(j.coord_name)
                k += 1
        self._coord_of_body = tuple(coord_of_body)
        self._coords_of_body = tuple((c,) if c >= 0 else ()
                                     for c in coord_of_body)
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
    def _joint_net(self, i, p, q):
        """Net (E, r) parent-body -> child-body map and the motion subspace
        S (6,) in child coordinates (None for a weld).

        Chain: parent offset frame -> joint transform -> inverse child
        offset frame, as in the JAX package."""
        spec = self.joints[i]
        ci = self._coord_of_body[i]
        E_T = p["tree_E"][i]
        r_T = p["tree_r"][i]
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
        E, r = E_j @ E_T, r_T + mv(E_T.transpose(-1, -2), r_j)
        cEt = cE.transpose(-1, -2)
        r = r + mv(E.transpose(-1, -2), -mv(cE, cr))
        E = cEt @ E
        if s_coef is None:
            return E, r, None
        Z = torch.zeros_like(cE)
        Xc = block2x2(cEt, Z, -cEt @ skew(-mv(cE, cr)), cEt)
        S = sum(Xc[..., :, k] * float(c) for k, c in enumerate(s_coef)
                if c != 0.0)
        return E, r, S

    def _Xup_S(self, i, p, q):
        """6x6 motion transform parent->body i and motion subspace."""
        E, r, S = self._joint_net(i, p, q)
        Xup = block2x2(E, torch.zeros_like(E), -E @ skew(r), E)
        return Xup, S

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
        loc = _const_vec(location, like)
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

    def rnea(self, p, q, u, udot):
        """Inverse dynamics: generalized forces balancing (q, u, udot) under
        gravity and velocity-product terms (Featherstone RBDA table 5.1)."""
        zero6 = q.new_zeros(6)
        a_base = torch.cat([q.new_zeros(3), -p["gravity"]])
        v, a, f, Xups, Ss = [], [], [], [], []
        for i in range(self.nb):
            Xup, S = self._Xup_S(i, p, q)
            ci = self._coord_of_body[i]
            if S is None:
                vJ = aJ = zero6
            else:
                vJ = S * u[..., ci, None]
                aJ = S * udot[..., ci, None]
            pa = self.parents[i]
            v_p = zero6 if pa == GROUND else v[pa]
            a_p = a_base if pa == GROUND else a[pa]
            v_i = mv(Xup, v_p) + vJ
            a_i = mv(Xup, a_p) + aJ + mv(crm(v_i), vJ)
            I = self._inertia(p, i)
            v.append(v_i)
            a.append(a_i)
            f.append(mv(I, a_i) + mv(crf(v_i), mv(I, v_i)))
            Xups.append(Xup)
            Ss.append(S)
        tau = [None] * self.nq
        for i in reversed(range(self.nb)):
            if Ss[i] is not None:
                tau[self._coord_of_body[i]] = (Ss[i] * f[i]).sum(-1)
            pa = self.parents[i]
            if pa != GROUND:
                f[pa] = f[pa] + mv(Xups[i].transpose(-1, -2), f[i])
        if not tau:
            return q.new_zeros(q.shape[:-1] + (0,))
        # entries that do not depend on the inputs broadcast to their shape
        return torch.stack(torch.broadcast_tensors(q[..., 0], u[..., 0],
                                                   udot[..., 0], *tau)[3:],
                           -1)

    def bias_forces(self, p, q, u):
        """C(q,u) + gravity terms: rnea with zero acceleration."""
        return self.rnea(p, q, u, torch.zeros_like(u))

    def mass_matrix(self, p, q):
        """Joint-space inertia matrix via the composite-rigid-body
        algorithm."""
        Ic, Xups, Ss = [], [], []
        for i in range(self.nb):
            Xup, S = self._Xup_S(i, p, q)
            Xups.append(Xup)
            Ss.append(S)
            Ic.append(self._inertia(p, i))
        for i in reversed(range(self.nb)):
            pa = self.parents[i]
            if pa != GROUND:
                Ic[pa] = Ic[pa] + Xups[i].transpose(-1, -2) @ Ic[i] @ Xups[i]
        nq = self.nq
        if nq == 0:
            return q.new_zeros(q.shape[:-1] + (0, 0))
        H = [[q.new_zeros(()) for _ in range(nq)] for _ in range(nq)]
        for i in range(self.nb):
            if Ss[i] is None:
                continue
            ci = self._coord_of_body[i]
            F = mv(Ic[i], Ss[i])
            H[ci][ci] = (Ss[i] * F).sum(-1)
            j = i
            while self.parents[j] != GROUND:
                F = mv(Xups[j].transpose(-1, -2), F)
                j = self.parents[j]
                cj = self._coord_of_body[j]
                if cj >= 0:
                    B = (Ss[j] * F).sum(-1)
                    H[cj][ci] = B
                    H[ci][cj] = B
        flat = torch.broadcast_tensors(q[..., 0],
                                       *[h for row in H for h in row])[1:]
        return torch.stack(flat, -1).reshape(q.shape[:-1] + (nq, nq))

    def forward_dynamics(self, p, q, u, tau_applied):
        """udot = M(q)^{-1} (tau_applied - bias(q, u))."""
        M = self.mass_matrix(p, q)
        b = self.bias_forces(p, q, u)
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
                 child_r=(0, 0, 0), child_E=None, joint_label=None):
        """Add a body and the joint that connects it to ``parent``.

        ``tree_r``/``tree_E`` give the joint frame pose in the parent frame;
        ``child_r``/``child_E`` its pose in the child frame."""
        if kind in _UNPORTED_KINDS:
            raise NotImplementedError(
                f"{kind!r} joints are not ported yet (ROADMAP.md, queue 1)")
        if kind not in _VALID_KINDS:
            raise ValueError(f"unknown joint kind {kind!r}")
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
        if kind != "weld":
            ax = ax / np.linalg.norm(ax)
        self._bodies.append(BodySpec(name, float(mass),
                                     tuple(np.asarray(com, dtype=np.float64)),
                                     tuple(map(tuple, inertia))))
        self._joints.append(JointSpec(joint_name, kind,
                                      tuple(float(a) for a in ax),
                                      coord_name, joint_label or joint_name))
        self._parents.append(self._name_to_idx[parent])
        self._tree_E.append(np.asarray(tree_E, dtype=np.float64))
        self._tree_r.append(np.asarray(tree_r, dtype=np.float64))
        self._child_E.append(np.asarray(child_E, dtype=np.float64))
        self._child_r.append(np.asarray(child_r, dtype=np.float64))
        self._name_to_idx[name] = len(self._bodies) - 1
        return self._name_to_idx[name]

    def finalize(self) -> MechModel:
        return MechModel(self._bodies, self._joints, self._parents,
                         np.stack(self._tree_E), np.stack(self._tree_r),
                         self._gravity, np.stack(self._child_E),
                         np.stack(self._child_r))
