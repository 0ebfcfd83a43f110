"""Model composition: mechanics + coordinate actuators + DGF muscles +
contact + measured external loads.

Counterpart of ``opensim_moco_tpu.models.model``. State layout (system
order) ``y = [q, u, z]`` with the auxiliary states ordered per muscle as
[activation?, normalized tendon force?]; one control per coordinate
actuator, then one excitation per muscle, then one control per custom
control force.

Muscle tensions, contact forces and external loads act at points fixed in
bodies; their generalized forces are the points' Jacobian transpose times
the forces, taken by the backward pass of RNEA from one pass over the tree
(the JAX package takes it from ``jax.vjp`` of the points). A conditional
path point (OpenSim ConditionalPathPoint) keeps its muscle on that path:
the tension acts on the segments through the point or on the segment that
skips it, as the coordinate selects. A muscle with a moving path point
(its location a function of a coordinate) or a wrap cylinder has a length
that is no sum of segments between body-fixed points: its rate and its
generalized force ``-(dL/dq)^T F`` come from a ``jvp`` and a ``vjp`` of
that muscle's length alone. Every per-muscle selection is static (Python
indices), so no index tensor is built per call and no unused branch is
evaluated.

Also ported: springs/dampers on coordinates, station contact (three force
laws) and smooth sphere contact against the ground plane, custom control
forces, kinematic constraints (with their Lagrange multipliers),
prescribed motion (the MocoInverse structure: ``y = z`` only, the
multibody dynamics a force balance), the applied body wrenches and the
joint reactions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..convert import params_from_numpy
from . import muscle as dgf
from .mech import GROUND, MechModel, _const_vec, spd_solve
from .spatial import mv
from .wrap import chained_wrap_length, cylinder_wrap_length


def _take(t, idx):
    """``t[..., idx]`` for a static index list, without an index tensor."""
    idx = [int(i) for i in idx]
    if idx == list(range(t.shape[-1])):
        return t
    return torch.stack([t[..., i] for i in idx], -1)


def _take_params(mp, idx):
    return {k: _take(v, idx) for k, v in mp.items()}


def _norm(v):
    return torch.sqrt((v * v).sum(-1))


def _loc(location, like):
    """A body-local point as a tensor: a static triple or a tensor."""
    return (location if torch.is_tensor(location)
            else _const_vec(location, like))


@dataclasses.dataclass(frozen=True)
class CoordinateActuatorSpec:
    """tau = optimal_force * control at one coordinate (OpenSim
    CoordinateActuator)."""
    name: str
    coord: int
    optimal_force: float = 1.0
    min_control: float = -np.inf
    max_control: float = np.inf


@dataclasses.dataclass(frozen=True)
class SpringGeneralizedForceSpec:
    """F = -stiffness (q - rest_length) - viscosity u on one coordinate
    (OpenSim SpringGeneralizedForce; JAX ``models/model.py:47``)."""
    name: str
    coord: int
    stiffness: float = 0.0
    rest_length: float = 0.0
    viscosity: float = 0.0


@dataclasses.dataclass(frozen=True)
class MuscleSpec:
    """DeGrooteFregly2016 muscle on a path of straight segments between
    path points (JAX ``models/model.py:59``):

    * ``("fixed", body, (x, y, z))``
    * ``("conditional", body, (x, y, z), coord_idx, lo, hi)``: on the path
      only while the coordinate is in [lo, hi] (ConditionalPathPoint)
    * ``("moving", body, ((fx, cx), (fy, cy), (fz, cz)))``: each location
      component a function of a coordinate, or None for 0
      (MovingPathPoint); a function maps a tensor elementwise

    ``wraps``: ((WrapCylinderSpec, candidate_segments), ...) in PathWrapSet
    order, the candidates 0-based indices of the path's straight
    segments. A wrap adds its largest detour over its candidates; wraps
    that list the same single candidate are chained on it."""
    name: str
    path: tuple
    ignore_activation_dynamics: bool = False
    ignore_tendon_compliance: bool = False
    tendon_dynamics_implicit: bool = False
    ignore_passive_fiber_force: bool = False
    wraps: tuple = ()
    min_control: float = 0.0
    max_control: float = 1.0


@dataclasses.dataclass(frozen=True)
class SphereContactSpec:
    """SmoothSphereHalfSpaceForce against the ground plane y = 0 (JAX
    ``models/model.py:92``; the smooth Hertz, Hunt-Crossley and friction
    model of Serrancoli et al. 2019, parameter names as in the reference
    XML)."""
    name: str
    body: int
    location: tuple  # sphere center in body frame
    radius: float
    stiffness: float = 1e6
    dissipation: float = 2.0
    static_friction: float = 0.8
    dynamic_friction: float = 0.8
    viscous_friction: float = 0.5
    transition_velocity: float = 0.2
    constant_contact_force: float = 1e-5
    hertz_smoothing: float = 300.0
    hunt_crossley_smoothing: float = 50.0
    derivative_smoothing: float = 1e-5


def smooth_sphere_halfspace_force(cp_pos, cp_vel, spec: SphereContactSpec):
    """World force (..., 3) on the body at the sphere's lowest point
    against the plane y = 0, from that point's position and velocity
    (..., 3) (JAX ``models/model.py:113``)."""
    cd = spec.derivative_smoothing
    indentation = -cp_pos[..., 1]
    indentation_vel = -cp_vel[..., 1]
    delta_s = torch.sqrt(indentation ** 2 + cd)
    fH = (4.0 / 3.0) * spec.stiffness * np.sqrt(spec.radius) * \
        delta_s ** 1.5
    fH = fH * 0.5 * (1.0 + torch.tanh(spec.hertz_smoothing * indentation))
    damp = 1.0 + 1.5 * spec.dissipation * indentation_vel
    fHC = fH * damp
    fn = fHC * 0.5 * (1.0 + torch.tanh(spec.hunt_crossley_smoothing * damp)) \
        + spec.constant_contact_force
    # friction in the plane
    vt = torch.sqrt(cp_vel[..., 0] ** 2 + cp_vel[..., 2] ** 2 + cd)
    vrel = vt / spec.transition_velocity
    mu = spec.dynamic_friction * torch.tanh(vrel) + \
        spec.viscous_friction * vt
    ft = -mu * fn / vt
    return torch.stack([ft * cp_vel[..., 0], fn, ft * cp_vel[..., 2]], -1)


@dataclasses.dataclass(frozen=True)
class StationContactSpec:
    """Smooth station-against-ground-plane contact (JAX
    ``models/model.py:140``; reference StationPlaneContactForce.h).
    ``model`` selects the force law: "ackermann"
    (AckermannVanDenBogert2010, cubic spring; the default), "meyer"
    (MeyerFregly2016, log-cosh spring; uses ``tscale``) or "esposito"
    (EspositoMiller2018, smoothed quadratic; uses ``depth_offset``)."""
    name: str
    body: int
    location: tuple
    stiffness: float = 5e7
    dissipation: float = 1.0
    friction_coefficient: float = 1.0
    tangent_velocity_scaling: float = 0.05
    model: str = "ackermann"
    tscale: float = 1.0
    depth_offset: float = 0.001


def _planar_force(fx, fy):
    return torch.stack([fx, fy, torch.zeros_like(fx)], -1)


def avdb_contact_force(pos, vel, stiffness, dissipation, friction_coefficient,
                       tangent_velocity_scaling):
    """AckermannVanDenBogert2010 smooth contact, world force (..., 3) at the
    station: a cubic normal force with dissipation, a small void stiffness
    and a tanh friction transition (JAX ``models/model.py:160``)."""
    depth = -pos[..., 1]
    depth_rate = -vel[..., 1]
    fy = torch.clamp(stiffness * depth ** 3 * (1 + dissipation * depth_rate),
                     min=0.0)
    fy = torch.where(depth > 0, fy, torch.zeros_like(fy))
    void_stiffness = 1.0
    fy = fy + void_stiffness * depth
    transition = torch.tanh(vel[..., 0] / tangent_velocity_scaling / 2.0)
    return _planar_force(-transition * friction_coefficient * fy, fy)


def meyer_fregly_contact_force(pos, vel, stiffness, dissipation, tscale):
    """MeyerFregly2016 smooth contact: a log-cosh spring blending a small
    out-of-contact stiffness into the in-contact one, times a Hunt-Crossley
    dissipation factor; tanh friction with mu_d = 1, latch velocity
    0.05 m/s (JAX ``models/model.py:180``)."""
    y = pos[..., 1]
    depth_rate = -vel[..., 1]
    klow = 1e-1 / (tscale * tscale)
    h = 1e-3
    c = 5e-4
    ymax = 1e-2
    vp = (stiffness + klow) / (stiffness - klow)
    sp = (stiffness - klow) / 2.0
    # log(cosh(x)) overflows for |x| above about 350: |x| - log 2 there
    xo = (y + h) / c
    log_cosh = torch.where(xo.abs() > 30.0, xo.abs() - np.log(2.0),
                           torch.log(torch.cosh(torch.clamp(xo, -30.0,
                                                            30.0))))
    constant = -sp * (vp * ymax - c * np.log(np.cosh((ymax + h) / c)))
    f_spring = -sp * (vp * y - c * log_cosh) - constant
    fy = f_spring * (1.0 + dissipation * depth_rate)
    mu = torch.tanh(vel[..., 0] / 0.05 / 2.0)
    return _planar_force(-fy * mu, fy)


def esposito_miller_contact_force(pos, vel, stiffness, dissipation,
                                  friction_coefficient,
                                  tangent_velocity_scaling, depth_offset):
    """EspositoMiller2018 smooth contact: (sqrt(depth^2 + offset^2) +
    depth) / 2 gates a quadratic spring smoothly; Hunt-Crossley
    dissipation; tanh friction (JAX ``models/model.py:205``)."""
    depth = -pos[..., 1]
    depth_rate = -vel[..., 1]
    dy = 0.5 * (torch.sqrt(depth ** 2 + depth_offset ** 2) + depth)
    void_stiffness = 1.0
    fy = stiffness * dy ** 2 * (1.0 + dissipation * depth_rate) + \
        void_stiffness * depth
    transition = torch.tanh(vel[..., 0] / tangent_velocity_scaling)
    return _planar_force(-transition * friction_coefficient * fy, fy)


def station_contact_force(pos, vel, spec: StationContactSpec, stiffness,
                          dissipation, friction_coefficient):
    """The force law of a StationContactSpec, chosen by its static
    ``model`` (JAX ``models/model.py:222``)."""
    if spec.model == "meyer":
        return meyer_fregly_contact_force(pos, vel, stiffness, dissipation,
                                          spec.tscale)
    if spec.model == "esposito":
        return esposito_miller_contact_force(
            pos, vel, stiffness, dissipation, friction_coefficient,
            spec.tangent_velocity_scaling, spec.depth_offset)
    return avdb_contact_force(pos, vel, stiffness, dissipation,
                              friction_coefficient,
                              spec.tangent_velocity_scaling)


class Model:
    """Mutable builder; call :meth:`finalize` before use in a Problem."""

    def __init__(self, mech: MechModel):
        self.mech = mech
        self.actuators: list[CoordinateActuatorSpec] = []
        self.springs: list[SpringGeneralizedForceSpec] = []
        self.kinematic_constraints: list = []  # (name, fn)
        self.couplers: list = []  # (dependent, independent, fn)
        self.muscles: list[MuscleSpec] = []
        self._muscle_params: list[dict] = []
        self.contacts: list[StationContactSpec] = []
        self.sphere_contacts: list[SphereContactSpec] = []
        # measured external loads: dicts with body, force_fn(t),
        # point_fn(t), torque_fn(t) or None
        self.external_forces: list[dict] = []
        # (name, fn, min_control, max_control), fn(p, t, q, u, control)
        self.custom_control_forces: list[tuple] = []
        # the MarkerSet: marker name -> (body index, location in the body
        # frame), read by MarkerTrackingGoal and Track (JAX
        # models/model.py:252-255); no parameter, so not in ``p``
        self.markers: dict[str, tuple] = {}
        self.position_motion = None
        self.prescribed = False
        self._finalized = False

    # ------------------------------------------------------------- builders
    def coord_index(self, coord_name: str) -> int:
        return self.mech.coord_names.index(coord_name)

    def add_coordinate_actuator(self, name, coord, optimal_force=1.0,
                                min_control=-np.inf, max_control=np.inf):
        ci = self.coord_index(coord) if isinstance(coord, str) else coord
        self.actuators.append(CoordinateActuatorSpec(
            name, ci, float(optimal_force), float(min_control),
            float(max_control)))

    def add_muscle(self, name, path, params=None,
                   ignore_activation_dynamics=False,
                   ignore_tendon_compliance=False,
                   tendon_dynamics_implicit=False,
                   ignore_passive_fiber_force=False,
                   wraps=(), min_control=0.0, max_control=1.0):
        """JAX ``models/model.py:286``: legacy ``(body, loc)`` pairs and
        inline ``("wrap", spec)`` markers (a wrap pinned to the segment it
        was inserted into) are normalized; candidate segments outside the
        path are dropped."""
        if params is None:
            params = dgf.default_muscle_params()
        norm_path = []
        norm_wraps = list(wraps)
        for pt in path:
            if isinstance(pt[0], str):
                if pt[0] == "wrap":
                    norm_wraps.append((pt[1], (len(norm_path) - 1,)))
                    continue
                norm_path.append(tuple(pt))
            else:  # legacy (body, loc) pairs
                norm_path.append(("fixed", pt[0], tuple(pt[1])))
        # a conditional point has plain neighbours (as in the reference
        # gait models): the path-length switch assumes it
        has_cond = False
        for i, pt in enumerate(norm_path):
            if pt[0] == "conditional":
                has_cond = True
                assert 0 < i < len(norm_path) - 1, \
                    "conditional path point cannot be an endpoint"
                assert norm_path[i - 1][0] != "conditional" and \
                    norm_path[i + 1][0] != "conditional", \
                    "adjacent conditional path points unsupported"
        assert not (has_cond and norm_wraps), \
            "wraps on paths with conditional points unsupported"
        nseg = len(norm_path) - 1
        norm_wraps = tuple(
            (spec, tuple(k for k in cands if 0 <= k < nseg))
            for spec, cands in norm_wraps)
        self.muscles.append(MuscleSpec(
            name, tuple(norm_path), ignore_activation_dynamics,
            ignore_tendon_compliance, tendon_dynamics_implicit,
            ignore_passive_fiber_force, norm_wraps, float(min_control),
            float(max_control)))
        self._muscle_params.append(params)

    def add_spring_generalized_force(self, name, coord, stiffness=0.0,
                                     rest_length=0.0, viscosity=0.0):
        """JAX ``models/model.py:280``."""
        ci = self.coord_index(coord) if isinstance(coord, str) else coord
        self.springs.append(SpringGeneralizedForceSpec(
            name, ci, float(stiffness), float(rest_length), float(viscosity)))

    def add_station_contact(self, name, body, location, **kwargs):
        """JAX ``models/model.py:331``; ``kwargs`` are
        :class:`StationContactSpec` fields."""
        self.contacts.append(StationContactSpec(name, body, tuple(location),
                                                **kwargs))

    def add_sphere_contact(self, name, body, location, radius, **kwargs):
        """JAX ``models/model.py:335``; ``kwargs`` are
        :class:`SphereContactSpec` fields."""
        self.sphere_contacts.append(SphereContactSpec(
            name, body, tuple(location), float(radius), **kwargs))

    def add_external_force(self, name, body, force_fn, point_fn,
                           torque_fn=None):
        """A measured external load (OpenSim ExternalForce; JAX
        ``models/model.py:339``): a world force applied at a world point,
        and an optional world torque, each a function of the time tensor
        ``t`` (...) returning (..., 3)."""
        self.external_forces.append({
            "name": name, "body": body, "force_fn": force_fn,
            "point_fn": point_fn, "torque_fn": torque_fn})

    def add_custom_control_force(self, name, fn, min_control=-np.inf,
                                 max_control=np.inf):
        """A scalar-controlled generalized force with any control
        dependence (JAX ``models/model.py:348``): ``fn(p, t, q, u,
        control) -> (..., nq)`` on the port's batched tensors. Appends one
        control, /forceset/<name>."""
        self.custom_control_forces.append(
            (name, fn, float(min_control), float(max_control)))

    def add_kinematic_constraint(self, name, fn):
        """``fn(mech_params, q) -> (..., k)`` position-level residuals for
        q (..., nq) with any leading dims (JAX ``models/model.py:359``).
        It runs under ``torch.func`` transforms: no in-place writes."""
        self.kinematic_constraints.append((name, fn))

    # --- the Simbody constraint types (JAX models/model.py:363-481); each
    # is a phi(q) builder, which the transcription treats uniformly
    def _body_point_world(self, frames, body, loc, like):
        """JAX ``models/model.py:367``."""
        return self.mech._station_world(frames, body, loc, like)

    def add_point_constraint(self, name, body1, loc1, body2, loc2):
        """The two body-fixed stations coincide (Constraint::Ball).
        3 equations."""

        def phi(mp, q):
            fr = self.mech.frames(mp, q)
            return (self._body_point_world(fr, body1, loc1, q) -
                    self._body_point_world(fr, body2, loc2, q))

        self.add_kinematic_constraint(name, phi)

    def add_weld_constraint(self, name, body1, body2, loc1=(0, 0, 0),
                            loc2=(0, 0, 0)):
        """Coincident stations and zero relative orientation
        (Constraint::Weld). 6 equations: 3 of the point, 3 of the skew
        part of the relative rotation."""

        def frame_R(fr, body, q):
            if body == GROUND:
                return torch.diag_embed(_const_vec((1.0, 1.0, 1.0), q))
            return fr[body][0]

        def phi(mp, q):
            fr = self.mech.frames(mp, q)
            p1 = self._body_point_world(fr, body1, loc1, q)
            p2 = self._body_point_world(fr, body2, loc2, q)
            R = frame_R(fr, body1, q) @ frame_R(fr, body2, q).transpose(
                -1, -2)
            rot = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                               R[..., 0, 2] - R[..., 2, 0],
                               R[..., 1, 0] - R[..., 0, 1]], -1) * 0.5
            p1, p2, rot = torch.broadcast_tensors(p1, p2, rot)
            return torch.cat([p1 - p2, rot], -1)

        self.add_kinematic_constraint(name, phi)

    def add_point_on_line_constraint(self, name, line_body, line_origin,
                                     line_direction, follower_body,
                                     follower_point):
        """The follower station lies on a line fixed in ``line_body``
        (Constraint::PointOnLine). 2 equations: the offset's components
        orthogonal to the line."""
        d = np.asarray(line_direction, dtype=np.float64)
        d = d / np.linalg.norm(d)
        # orthonormal complement of the line direction (static)
        a = np.array([1.0, 0.0, 0.0])
        if abs(d @ a) > 0.9:
            a = np.array([0.0, 1.0, 0.0])
        e1 = np.cross(d, a)
        e1 /= np.linalg.norm(e1)
        e2 = np.cross(d, e1)

        def phi(mp, q):
            fr = self.mech.frames(mp, q)
            pf = self._body_point_world(fr, follower_body, follower_point, q)
            off = pf - self._body_point_world(fr, line_body, line_origin, q)
            e1w, e2w = _const_vec(e1, q), _const_vec(e2, q)
            if line_body != GROUND:
                At = fr[line_body][0].transpose(-1, -2)
                e1w, e2w = mv(At, e1w), mv(At, e2w)
            return torch.stack([(off * e1w).sum(-1), (off * e2w).sum(-1)],
                               -1)

        self.add_kinematic_constraint(name, phi)

    def add_constant_distance_constraint(self, name, body1, loc1, body2,
                                         loc2, distance):
        """Fixed distance between two stations
        (Constraint::ConstantDistance). 1 equation, on the squared
        distance for smoothness."""

        def phi(mp, q):
            fr = self.mech.frames(mp, q)
            diff = (self._body_point_world(fr, body1, loc1, q) -
                    self._body_point_world(fr, body2, loc2, q))
            return (0.5 * ((diff * diff).sum(-1) - distance * distance) /
                    distance).unsqueeze(-1)

        self.add_kinematic_constraint(name, phi)

    def add_locked_coordinate_constraint(self, name, coord, value):
        """Lock a coordinate at a value. 1 equation."""
        ci = self.coord_index(coord) if isinstance(coord, str) else coord

        def phi(mp, q):
            return q[..., ci:ci + 1] - value

        self.add_kinematic_constraint(name, phi)

    def add_coordinate_coupler_constraint(self, name, dependent,
                                          independent, fn):
        """q_dep = fn(q_ind) (CoordinateCouplerConstraint); ``fn`` maps a
        tensor elementwise."""
        di = self.coord_index(dependent) if isinstance(dependent, str) \
            else dependent
        ii = self.coord_index(independent) if isinstance(independent, str) \
            else independent
        self.couplers.append((di, ii, fn))

        def phi(mp, q):
            return q[..., di:di + 1] - fn(q[..., ii:ii + 1])

        self.add_kinematic_constraint(name, phi)

    def set_position_motion(self, fn):
        """Prescribe all coordinates: ``fn(params, t) -> (q, u, udot)``,
        each (..., nq) for times t (...). The multibody states leave the
        OCP and the multibody dynamics reduce to a force balance (inverse
        dynamics), the basis of MocoInverse (JAX
        ``models/model.py:482``)."""
        self.position_motion = fn

    def set_position_motion_from_table(self, times, coord_values):
        """The position motion from sampled coordinates, (K, nq) in
        coordinate order, through quintic splines (the reference's
        PositionMotion::createFromTable; JAX ``models/model.py:491``)."""
        from ..utils.splines import QuinticSpline

        spline = QuinticSpline(times, coord_values)

        def fn(p, t):
            return (spline(t), spline.derivative(t),
                    spline.second_derivative(t))

        self.position_motion = fn

    # ------------------------------------------------------------- layouts
    def finalize(self):
        self.nq = self.mech.nq
        self._aux_index: list[tuple[str, str]] = []  # (muscle, kind)
        for ms in self.muscles:
            if not ms.ignore_activation_dynamics:
                self._aux_index.append((ms.name, "activation"))
            if not ms.ignore_tendon_compliance:
                self._aux_index.append((ms.name, "normalized_tendon_force"))
        self.naux = len(self._aux_index)
        self.prescribed = self.position_motion is not None
        self.ny = self.naux if self.prescribed else 2 * self.nq + self.naux
        self.nx = len(self.actuators) + len(self.muscles)
        self._implicit_aux: list[str] = [
            m.name for m in self.muscles
            if (not m.ignore_tendon_compliance) and m.tendon_dynamics_implicit]
        self.n_implicit_aux = len(self._implicit_aux)
        # equations per kinematic constraint, for the multiplier count and
        # names (JAX models/model.py:561-562)
        mp0 = self.mech.default_params("cpu")
        q0 = torch.zeros(self.nq, dtype=torch.float64)
        self._constraint_eqs = [(name, int(fn(mp0, q0).numel()))
                                for name, fn in self.kinematic_constraints]
        self.nphi = sum(k for _, k in self._constraint_eqs)
        # static per-muscle index tables (the JAX package's ``_mv``)
        nm = len(self.muscles)
        aux_pos = {key: k for k, key in enumerate(self._aux_index)}
        na = len(self.actuators)
        self._mv = {
            "act_from_z": np.zeros(nm, bool),
            "act_zidx": np.zeros(nm, np.int32),
            "exc_xidx": np.asarray([na + i for i in range(nm)], np.int32),
            "ft_zidx": np.zeros(nm, np.int32),
            "rigid": np.zeros(nm, bool),
            "implicit": np.zeros(nm, bool),
            "nopass": np.zeros(nm, bool),
            "imp_didx": np.zeros(nm, np.int32),
        }
        for i, ms in enumerate(self.muscles):
            if not ms.ignore_activation_dynamics:
                self._mv["act_from_z"][i] = True
                self._mv["act_zidx"][i] = aux_pos[(ms.name, "activation")]
            if ms.ignore_tendon_compliance:
                self._mv["rigid"][i] = True
            else:
                self._mv["ft_zidx"][i] = aux_pos[
                    (ms.name, "normalized_tendon_force")]
                if ms.tendon_dynamics_implicit:
                    self._mv["implicit"][i] = True
                    self._mv["imp_didx"][i] = \
                        self._implicit_aux.index(ms.name)
            self._mv["nopass"][i] = ms.ignore_passive_fiber_force
        self._finalized = True
        return self

    # names --------------------------------------------------------------
    def multiplier_names(self):
        """One Lagrange multiplier per constraint equation, in the row
        order of :meth:`phi`, named "lambda_cid{cid}_p{i}" (JAX
        ``models/model.py:567``)."""
        return [f"lambda_cid{cid}_p{i}"
                for cid, (_, k) in enumerate(self._constraint_eqs)
                for i in range(k)]

    def coordinate_paths(self):
        """Moco-style absolute paths per coordinate, in coordinate order (a
        custom joint gives one path per coordinate)."""
        paths = []
        for j in self.mech.joints:
            if j.kind == "weld":
                continue
            base = f"/jointset/{j.label or j.name}"
            names = j.coord_names if j.kind == "custom" else (j.coord_name,)
            paths.extend(f"{base}/{cn}" for cn in names)
        return paths

    def state_names(self):
        aux = [f"/forceset/{m}/{kind}" for m, kind in self._aux_index]
        if self.prescribed:  # the coordinates are data, not states
            return aux
        cpaths = self.coordinate_paths()
        names = [f"{c}/value" for c in cpaths]
        names += [f"{c}/speed" for c in cpaths]
        return names + aux

    def control_names(self):
        return ([f"/forceset/{a.name}" for a in self.actuators] +
                [f"/forceset/{m.name}" for m in self.muscles] +
                [f"/forceset/{c[0]}" for c in self.custom_control_forces])

    def default_control_bounds(self):
        lo = [a.min_control for a in self.actuators] + \
            [m.min_control for m in self.muscles] + \
            [c[2] for c in self.custom_control_forces]
        hi = [a.max_control for a in self.actuators] + \
            [m.max_control for m in self.muscles] + \
            [c[3] for c in self.custom_control_forces]
        return np.array(lo), np.array(hi)

    def default_state_bounds(self):
        """(lo, hi) per state: speeds in [-50, 50], activations inherit
        the excitation bounds, tendon forces in [0, 5] (JAX
        ``models/model.py:621``; no coordinate states when prescribed)."""
        lo = np.full(self.ny, -np.inf)
        hi = np.full(self.ny, np.inf)
        off = 0 if self.prescribed else 2 * self.nq
        if not self.prescribed:
            lo[self.nq:2 * self.nq] = -50.0
            hi[self.nq:2 * self.nq] = 50.0
        mus_by_name = {ms.name: ms for ms in self.muscles}
        for i, (m, kind) in enumerate(self._aux_index):
            if kind == "activation":
                ms = mus_by_name[m]
                lo[off + i], hi[off + i] = ms.min_control, ms.max_control
            else:
                lo[off + i] = dgf.MIN_NORM_TENDON_FORCE
                hi[off + i] = dgf.MAX_NORM_TENDON_FORCE
        return lo, hi

    # ------------------------------------------------------------- params
    def numpy_params(self) -> dict:
        """Parameter tree as numpy arrays, with the keys and shapes of the
        JAX package's ``Model.default_params``."""
        p = {"mech": self.mech.numpy_params()}
        if self.muscles:
            p["muscles"] = dgf.stack_muscle_params(self._muscle_params)
        if self.actuators:
            p["actuator_optimal_force"] = np.asarray(
                [a.optimal_force for a in self.actuators])
        if self.springs:  # JAX models/model.py:652-657
            p["spring"] = {
                key: np.asarray([getattr(s, key) for s in self.springs])
                for key in ("stiffness", "rest_length", "viscosity")}
        if self.contacts:  # JAX models/model.py:659-665
            p["contact"] = {
                key: np.asarray([getattr(c, key) for c in self.contacts])
                for key in ("stiffness", "dissipation",
                            "friction_coefficient")}
        return p

    def default_params(self, device="cuda", dtype=torch.float64) -> dict:
        """Parameter dict of tensors on ``device``."""
        return params_from_numpy(self.numpy_params(), device, dtype)

    # ------------------------------------------------------------ splitting
    def split_state(self, y):
        """(q, u, z) of a full state (not of a prescribed problem's, which
        holds z alone)."""
        q = y[..., :self.nq]
        u = y[..., self.nq:2 * self.nq]
        z = y[..., 2 * self.nq:]
        return q, u, z

    def muscle_state(self, z, x, mi: int):
        """(activation, norm_tendon_force_or_None) for muscle mi."""
        name = self.muscles[mi].name
        act = None
        ft = None
        for k, (mname, kind) in enumerate(self._aux_index):
            if mname != name:
                continue
            if kind == "activation":
                act = z[..., k]
            else:
                ft = z[..., k]
        if act is None:  # activation dynamics ignored: activation = excitation
            act = x[..., len(self.actuators) + mi]
        return act, ft

    # ------------------------------------------------------------- forces
    @staticmethod
    def _is_simple(ms):
        """True for a muscle whose path points are all fixed in bodies
        (fixed and conditional points) and that has no wrap: its length
        is a sum of segments between body-fixed points."""
        return not ms.wraps and all(pt[0] != "moving" for pt in ms.path)

    @staticmethod
    def _active(q, pt):
        """Whether a conditional path point is on the path: its coordinate
        in [lo, hi] (..., bool)."""
        qc = q[..., pt[3]]
        return (qc >= pt[4]) & (qc <= pt[5])

    def _path_point_world(self, frames, q, pt):
        """World position (..., 3) of one path point of any kind (JAX
        ``models/model.py:693``)."""
        loc = pt[2]
        if pt[0] == "moving":
            comps = [torch.zeros_like(q[..., 0]) if fn is None
                     else fn(q[..., ci]) for fn, ci in loc]
            loc = torch.stack(torch.broadcast_tensors(*comps), -1)
        return self.mech._station_world(frames, pt[1], loc, q)

    def path_lengths(self, p, q):
        """(..., n_muscles) path lengths (JAX ``models/model.py:712``): a
        conditional point switches between a-p-b and the direct a-b
        segment, wraps add their detours."""
        return self._lengths_of(p, q, range(len(self.muscles)))

    def _path_steps(self, q, ms):
        """The muscle's path as steps (i, active): with ``active`` None the
        straight segment from point i to i + 1; else point i + 1 is
        conditional, ``active`` (..., bool) its activity, and the step is
        i -> i + 1 -> i + 2 where it is active, i -> i + 2 where not."""
        i, n = 0, len(ms.path)
        while i < n - 1:
            nxt = ms.path[i + 1]
            if nxt[0] == "conditional":
                yield i, self._active(q, nxt)
                i += 2
            else:
                yield i, None
                i += 1

    def _cyl_frame_maps(self, frames, spec, like):
        """(to_cyl, from_cyl): the world <-> cylinder coordinate maps of a
        wrap cylinder (JAX ``models/model.py:719``)."""
        A, o = frames[spec.body]
        At = A.transpose(-1, -2)
        Ec = torch.stack([_const_vec(row, like) for row in spec.rotation()])
        Ect = Ec.transpose(-1, -2)
        tc = _const_vec(spec.translation, like)

        def to_cyl(x):
            return mv(Ec, mv(A, x - o) - tc)

        def from_cyl(c):
            return o + mv(At, mv(Ect, c) + tc)

        return to_cyl, from_cyl

    def _wrap_detours(self, frames, q, ms, pts):
        """The extra length the muscle's wrap cylinders add (JAX
        ``models/model.py:733``). A wrap with several candidate segments
        adds max_k(L_wrap(segment k) - |segment k|) over them (the wrap
        engages where it deflects the path most); wraps that share one
        single candidate segment are chained on it, proximal first (a
        lower body index is nearer the path's origin: the tree is
        topologically ordered)."""
        detour = q.new_zeros(())
        groups, singles = {}, []
        for spec, cands in ms.wraps:
            if len(cands) == 1:
                groups.setdefault(cands[0], []).append(spec)
            else:
                singles.append((spec, cands))
        for seg, specs in groups.items():
            a, b = pts[seg], pts[seg + 1]
            straight = _norm(b - a + 1e-30)
            if len(specs) == 1:
                to_c, _ = self._cyl_frame_maps(frames, specs[0], q)
                L = cylinder_wrap_length(to_c(a), to_c(b), specs[0].radius,
                                         specs[0].quadrant)
            else:
                specs = sorted(specs, key=lambda s: s.body)
                L = chained_wrap_length(a, b, [
                    self._cyl_frame_maps(frames, s, q) + (s.radius,
                                                          s.quadrant)
                    for s in specs])
            detour = detour + torch.clamp(L - straight, min=0.0)
        for spec, cands in singles:
            to_c, _ = self._cyl_frame_maps(frames, spec, q)
            best = q.new_zeros(())
            for k in cands:
                a, b = pts[k], pts[k + 1]
                straight = _norm(b - a + 1e-30)
                L = cylinder_wrap_length(to_c(a), to_c(b), spec.radius,
                                         spec.quadrant)
                best = torch.maximum(best, L - straight)
            detour = detour + best
        return detour

    def _muscle_length(self, frames, q, ms):
        """One muscle's path length (...) (JAX ``models/model.py:784``)."""
        pts = [self._path_point_world(frames, q, pt) for pt in ms.path]

        def seg(i, j):
            return _norm(pts[j] - pts[i] + 1e-30)

        L = q.new_zeros(())
        for i, active in self._path_steps(q, ms):
            if active is None:
                L = L + seg(i, i + 1)
            else:
                L = L + torch.where(active, seg(i, i + 1) + seg(i + 1, i + 2),
                                    seg(i, i + 2))
        if ms.wraps:
            L = L + self._wrap_detours(frames, q, ms, pts)
        return L

    def _lengths_of(self, p, q, idx):
        """The path lengths (..., len(idx)) of the muscles ``idx``."""
        frames = self.mech.frames(p["mech"], q)
        return torch.stack(torch.broadcast_tensors(*[
            self._muscle_length(frames, q, self.muscles[i]) for i in idx]),
            -1)

    def muscle_path_kinematics(self, p, q, u):
        """lMT, vMT (..., nm): the path lengths and their rates (the JAX
        package's ``jvp`` of the lengths; here from the bodies' velocities
        where the points are fixed in bodies)."""
        L, Ldot, _ = self._path_kinematics(
            self.mech.kinematics(p["mech"], q, u, subspace=False), p, q, u)
        return L, Ldot

    def _simple_path(self, frames, vels, q, ms):
        """(L, Ldot, segments) of a muscle whose points are fixed in
        bodies: the segments as (body_a, local point a, body_b, local
        point b, unit vector from a to b (..., 3) times the segment's
        weight). A conditional point's segments get its activity as
        weight, the segment that skips it the complement."""
        locs = [(pt[1], _const_vec(pt[2], q)) for pt in ms.path]
        pv = [self.mech._station_world_velocity(frames, vels, body, loc, q)
              for body, loc in locs]
        segs = []

        def segment(i, j, w=None):
            (pa, va), (pb, vb) = pv[i], pv[j]
            d = pb - pa + 1e-30
            n = _norm(d)
            e = d / n.unsqueeze(-1)
            segs.append(locs[i] + locs[j] +
                        (e if w is None else e * w.unsqueeze(-1),))
            return n, (d * (vb - va)).sum(-1) / n

        L = Ldot = q.new_zeros(())
        for i, active in self._path_steps(q, ms):
            if active is None:
                l1, d1 = segment(i, i + 1)
                L = L + l1
                Ldot = Ldot + d1
            else:
                w = active.to(q.dtype)
                l1, d1 = segment(i, i + 1, w)
                l2, d2 = segment(i + 1, i + 2, w)
                l3, d3 = segment(i, i + 2, 1.0 - w)
                L = L + torch.where(active, l1 + l2, l3)
                Ldot = Ldot + torch.where(active, d1 + d2, d3)
        return L, Ldot, segs

    def _path_kinematics(self, kin, p, q, u):
        """(lMT, vMT, segments): the lengths and their rates (..., nm), and
        per muscle the segments of :meth:`_simple_path`, or None for a
        muscle with a moving point or a wrap, whose length and rate come
        from a ``jvp`` of its length alone (:meth:`_lengths_of`)."""
        frames = [(b.A, b.o) for b in kin]
        vels = [b.v for b in kin]
        Ls, Ldots, segments = [], [], []
        other = [i for i, ms in enumerate(self.muscles)
                 if not self._is_simple(ms)]
        if other:
            Lo, Ldo = torch.func.jvp(
                lambda qq: self._lengths_of(p, qq, other), (q,), (u,))
        for i, ms in enumerate(self.muscles):
            if i in other:
                k = other.index(i)
                L, Ldot, segs = Lo[..., k], Ldo[..., k], None
            else:
                L, Ldot, segs = self._simple_path(frames, vels, q, ms)
            Ls.append(L)
            Ldots.append(Ldot)
            segments.append(segs)
        return (torch.stack(torch.broadcast_tensors(*Ls), -1),
                torch.stack(torch.broadcast_tensors(*Ldots), -1), segments)

    def _muscle_vec_state(self, z, x):
        """(excitation, activation, norm_tendon_force) (..., nm); the tendon
        force of a rigid-tendon muscle is zero."""
        mv_ = self._mv
        exc = _take(x, mv_["exc_xidx"])
        act = torch.stack([
            z[..., mv_["act_zidx"][i]] if mv_["act_from_z"][i]
            else exc[..., i] for i in range(len(self.muscles))], -1)
        ft = torch.stack([
            torch.zeros_like(exc[..., i]) if mv_["rigid"][i]
            else z[..., mv_["ft_zidx"][i]]
            for i in range(len(self.muscles))], -1)
        return exc, act, ft

    def _muscle_forces_vec(self, p, act, ft, lMT, vMT):
        """Path tensions (..., nm): rigid-tendon closed form or the
        tendon-force state, chosen per muscle."""
        mp = p["muscles"]
        rigid = np.nonzero(self._mv["rigid"])[0]
        comp = np.nonzero(~self._mv["rigid"])[0]
        cols = [None] * len(self.muscles)
        if rigid.size:
            f_r = dgf.rigid_tendon_force(
                _take_params(mp, rigid), _take(act, rigid),
                _take(lMT, rigid), _take(vMT, rigid),
                self._mv["nopass"][rigid])
            for k, i in enumerate(rigid):
                cols[i] = f_r[..., k]
        if comp.size:
            f_c = dgf.tendon_force_from_state(_take_params(mp, comp),
                                              _take(ft, comp))
            for k, i in enumerate(comp):
                cols[i] = f_c[..., k]
        return torch.stack(torch.broadcast_tensors(*cols), -1)

    def tau_controls(self, p, x):
        """Generalized forces from coordinate actuators (linear in x)."""
        cols = [x.new_zeros(x.shape[:-1]) for _ in range(self.nq)]
        gains = p.get("actuator_optimal_force")
        for j, a in enumerate(self.actuators):
            cols[a.coord] = cols[a.coord] + gains[j] * x[..., j]
        return torch.stack(cols, -1)

    def spring_forces(self, p, q, u):
        """Generalized forces of the springs/dampers (JAX
        ``models/model.py:882-890``)."""
        sp = p["spring"]
        cols = [torch.zeros_like(q[..., 0]) for _ in range(self.nq)]
        for j, s in enumerate(self.springs):
            cols[s.coord] = cols[s.coord] + (
                -sp["stiffness"][j] * (q[..., s.coord] - sp["rest_length"][j])
                - sp["viscosity"][j] * u[..., s.coord])
        return torch.stack(cols, -1)

    def applied_generalized_forces(self, p, t, q, u, z, x,
                                   include_muscles=True,
                                   include_controls=True, kin=None):
        """Total applied generalized force f_app(t, y, x, p): actuators,
        custom control forces, springs, and the muscle tensions, contact
        forces and external loads mapped to generalized forces by the
        Jacobian transpose of their points (JAX ``models/model.py:858``,
        which takes that product from one ``vjp`` of the points and the
        rates from one ``jvp``; here both come from one pass over the
        tree, ``kin`` = ``mech.kinematics(q, u)``, made here if absent,
        and for a muscle with a moving point or a wrap from a ``jvp`` and a
        ``vjp`` of its length). ``include_muscles=False`` /
        ``include_controls=False`` drop those terms, leaving the part that
        the time alone fixes on a prescribed-kinematics problem; contact
        and external loads stay."""
        tau = (self.tau_controls(p, x) if include_controls
               else torch.zeros_like(q))
        if include_controls and self.custom_control_forces:
            # scalar-controlled forces with any control dependence (JAX
            # models/model.py:876-881)
            off = len(self.actuators) + len(self.muscles)
            for j, (_, fn, _, _) in enumerate(self.custom_control_forces):
                tau = tau + fn(p, t, q, u, x[..., off + j])
        if self.springs:
            tau = tau + self.spring_forces(p, q, u)
        nm = len(self.muscles) if include_muscles else 0
        if not (nm or self.sphere_contacts or self.contacts or
                self.external_forces):
            return tau
        if kin is None:
            kin = self.mech.kinematics(p["mech"], q, u)
        forces, moments = [], []
        if nm:
            L, Ldot, segments = self._path_kinematics(kin, p, q, u)
            exc, act, ft = self._muscle_vec_state(z, x)
            F_m = self._muscle_forces_vec(p, act, ft, L, Ldot)
            # the tension pulls each segment's ends towards each other
            other = []
            for m, segs in enumerate(segments):
                if segs is None:
                    other.append(m)
                    continue
                T = F_m[..., m, None]
                for body_a, loc_a, body_b, loc_b, e in segs:
                    forces.append((body_a, loc_a, T * e))
                    forces.append((body_b, loc_b, -T * e))
            if other:
                # -(dL/dq)^T F of the muscles whose length is no sum of
                # segments between body-fixed points
                _, pull = torch.func.vjp(
                    lambda qq: self._lengths_of(p, qq, other), q)
                tau = tau + pull(-_take(F_m, other))[0]
        points = self._contact_points(kin, q)
        if points:
            frames = [(b.A, b.o) for b in kin]
            P, Pdot = self._point_kinematics(frames, [b.v for b in kin],
                                             points, q)
            F = self._contact_force_stack(p, P, Pdot)
            forces += [(body, _loc(loc, q), F[..., k, :])
                       for k, (body, loc) in enumerate(points)]
        # external loads: the force at the body-local point coincident with
        # the measured centre of pressure at time t, frozen as the spheres'
        # points are (JAX models/model.py:909-915); the torque a pure
        # moment on the body (JAX :959-973, the grad of omega . T)
        for ef in self.external_forces:
            b = kin[ef["body"]]
            loc = mv(b.A, ef["point_fn"](t) - b.o).detach()
            forces.append((ef["body"], loc, ef["force_fn"](t)))
            if ef["torque_fn"] is not None:
                moments.append((ef["body"], ef["torque_fn"](t)))
        return tau + self.mech.point_forces_to_generalized(kin, q, forces,
                                                           moments)

    # -------------------------------------------------------------- contact
    def _contact_points(self, kin, q):
        """(body, body-local point) per contact, spheres first. A sphere's
        point is the body-local point that coincides with its lowest point
        at the pose of ``kin``, frozen: no derivative flows through that
        choice under any transform (``jax.lax.stop_gradient`` in the JAX
        package, ``models/model.py:898-907``)."""
        points = []
        for spec in self.sphere_contacts:
            A, o = kin[spec.body].A, kin[spec.body].o
            center_w = o + mv(A.transpose(-1, -2),
                              _const_vec(spec.location, q))
            cp_w = center_w - _const_vec((0.0, spec.radius, 0.0), q)
            points.append((spec.body, mv(A, cp_w - o).detach()))
        return points + [(c.body, c.location) for c in self.contacts]

    def _point_kinematics(self, frames, vels, points, q):
        """World positions and velocities (..., n, 3) of (body, local point)
        pairs."""
        pv = [self.mech._station_world_velocity(frames, vels, body, loc, q)
              for body, loc in points]
        P = torch.stack(torch.broadcast_tensors(*[a for a, _ in pv]), -2)
        V = torch.stack(torch.broadcast_tensors(*[b for _, b in pv]), -2)
        return P, V

    def _contact_force_stack(self, p, P, Pdot):
        """World forces (..., n_contacts, 3) from the contact points'
        positions and velocities (..., n_contacts, 3)."""
        ns = len(self.sphere_contacts)
        forces = [smooth_sphere_halfspace_force(P[..., k, :],
                                                Pdot[..., k, :], spec)
                  for k, spec in enumerate(self.sphere_contacts)]
        cp = p.get("contact")
        for j, c in enumerate(self.contacts):
            forces.append(station_contact_force(
                P[..., ns + j, :], Pdot[..., ns + j, :], c,
                cp["stiffness"][j], cp["dissipation"][j],
                cp["friction_coefficient"][j]))
        return torch.stack(forces, -2)

    def contact_names(self):
        return ([s.name for s in self.sphere_contacts] +
                [c.name for c in self.contacts])

    def contact_forces(self, p, t, q, u):
        """World-frame force (..., 3) on the body of each contact component,
        keyed by its name (JAX ``models/model.py:977``)."""
        if not (self.sphere_contacts or self.contacts):
            return {}
        kin = self.mech.kinematics(p["mech"], q, u, subspace=False)
        P, Pdot = self._point_kinematics(
            [(b.A, b.o) for b in kin], [b.v for b in kin],
            self._contact_points(kin, q), q)
        F = self._contact_force_stack(p, P, Pdot)
        return {name: F[..., k, :]
                for k, name in enumerate(self.contact_names())}

    def applied_body_wrenches(self, p, t, q, u, z, x):
        """(..., nb, 6) world wrenches [moment; force] about the body
        origins (JAX ``models/model.py:1007``): contact forces, external
        loads (the force at the measured point, and the torque) and the
        muscle tensions at the path points of each straight segment, a
        conditional point's weighted by its activity. The wrap cylinders'
        reactions are not included (the chord between the points around a
        wrap carries the tension), nor are coordinate actuators and
        springs: they are mobility forces, which the joints transmit."""
        kin = self.mech.kinematics(p["mech"], q, u, subspace=False)
        frames = [(b.A, b.o) for b in kin]
        W = [None] * self.mech.nb

        def put(body, w):
            if body != GROUND:
                W[body] = w if W[body] is None else W[body] + w

        def add(body, pt_w, f_w):
            if body != GROUND:
                put(body, torch.cat(torch.broadcast_tensors(
                    torch.linalg.cross(*torch.broadcast_tensors(
                        pt_w - frames[body][1], f_w)), f_w), -1))

        if self.sphere_contacts or self.contacts:
            cf = self.contact_forces(p, t, q, u)
            for spec in self.sphere_contacts:
                center_w = self.mech._station_world(frames, spec.body,
                                                    spec.location, q)
                add(spec.body, center_w - _const_vec(
                    (0.0, spec.radius, 0.0), q), cf[spec.name])
            for c in self.contacts:
                add(c.body, self.mech._station_world(frames, c.body,
                                                     c.location, q),
                    cf[c.name])
        for ef in self.external_forces:
            add(ef["body"], ef["point_fn"](t), ef["force_fn"](t))
            if ef["torque_fn"] is not None:
                T = ef["torque_fn"](t)
                put(ef["body"], torch.cat([T, torch.zeros_like(T)], -1))
        if self.muscles:
            lMT, vMT = self.muscle_path_kinematics(p, q, u)
            _, act, ft = self._muscle_vec_state(z, x)
            F = self._muscle_forces_vec(p, act, ft, lMT, vMT)
            for mi, ms in enumerate(self.muscles):
                pts = [(pt[1], self._path_point_world(frames, q, pt),
                        self._active(q, pt).to(q.dtype)
                        if pt[0] == "conditional" else None)
                       for pt in ms.path]
                Fm = F[..., mi, None]
                for k, (body, pw, w_act) in enumerate(pts):
                    f_w = torch.zeros_like(pw)
                    for j in (k - 1, k + 1):
                        if 0 <= j < len(pts):
                            d = pts[j][1] - pw
                            f_w = f_w + Fm * d / _norm(
                                d + 1e-30).unsqueeze(-1)
                    if w_act is not None:
                        f_w = f_w * w_act.unsqueeze(-1)
                    add(body, pw, f_w)
        shape = torch.broadcast_shapes(q.shape[:-1] + (6,), *[
            w.shape for w in W if w is not None])
        return torch.stack([q.new_zeros(shape) if w is None
                            else w.expand(shape) for w in W], -2)

    def joint_reaction(self, p, t, q, u, z, x, lam=None, udot=None):
        """(..., nb, 6) reaction wrench of every joint on its child body,
        in the world, about the joint's child-frame origin (JAX
        ``models/model.py:1083``; MocoJointReactionGoal's quantity).
        ``udot`` defaults to the explicit forward dynamics here. The
        constraint forces -G^T lam enter as mobility forces (exact for
        coordinate couplers)."""
        if udot is None:
            udot = self.multibody_explicit(p, t, q, u, z, x, lam)
        W = self.applied_body_wrenches(p, t, q, u, z, x)
        return self.mech.joint_reaction_wrenches(p["mech"], q, u, udot, W)

    # ---------------------------------------------------- kinematic cons
    def phi(self, p, q):
        """Stacked position-level constraint residuals (..., nphi) (JAX
        ``models/model.py:1098``)."""
        if not self.kinematic_constraints:
            return q.new_zeros(q.shape[:-1] + (0,))
        vals = [fn(p["mech"], q) for _, fn in self.kinematic_constraints]
        lead = q.shape[:-1]
        return torch.cat([v.expand(lead + v.shape[-1:]) for v in vals], -1)

    def constraint_jacobian(self, p, q):
        """G = d phi / dq, (..., nphi, nq): one forward tangent per
        coordinate, batched with ``vmap`` (JAX ``jacfwd``,
        ``models/model.py:1107``)."""
        eye = torch.eye(q.shape[-1], dtype=q.dtype, device=q.device)

        def col(e):
            return torch.func.jvp(lambda qq: self.phi(p, qq), (q,),
                                  (e.expand_as(q),))[1]

        return torch.func.vmap(col, out_dims=-1)(eye)

    def constraint_jacobian_T(self, p, q, lam):
        """G(q)^T lam, (..., nq), by one reverse pass through phi."""
        return torch.func.vjp(lambda qq: self.phi(p, qq), q)[1](lam)[0]

    # -------------------------------------------------------------- dynamics
    def multibody_explicit(self, p, t, q, u, z, x, lam=None):
        """udot = M^{-1} (f_app - bias - G^T lam) (JAX
        ``models/model.py:1110``)."""
        tau, M, b = self._multibody_terms(p, t, q, u, z, x, lam)
        return spd_solve(M, tau - b)

    def multibody_implicit_residual(self, p, t, q, u, z, x, lam, udot):
        """M udot + G^T lam - (f_app - bias) (N m)."""
        tau, M, b = self._multibody_terms(p, t, q, u, z, x, lam)
        return mv(M, udot) - (tau - b)

    def _multibody_terms(self, p, t, q, u, z, x, lam):
        """(f_app - G^T lam, M, bias) from one pass over the tree."""
        kin = self.mech.kinematics(p["mech"], q, u, rates=True)
        tau = self.applied_generalized_forces(p, t, q, u, z, x, kin=kin)
        if self.nphi:
            tau = tau - self.constraint_jacobian_T(p, q, lam)
        return (tau, self.mech.mass_matrix(p["mech"], q, kin),
                self.mech.bias_forces(p["mech"], q, u, kin))

    # ------------------------------------------ prescribed-kinematics cache
    def prescribed_point_constants(self, p, t):
        """The constants of the force balance at the grid times ``t`` (G,)
        of a prescribed-kinematics problem with a fixed time window and no
        parameters (JAX ``models/model.py:1131``), each with a leading G:

        - ``t, q, u, udot``;
        - ``tau_net`` = RNEA(q, u, udot) - the passive forces (springs);
        - ``R`` (G, nm, nq), the moment arms d lMT / dq, one ``jacfwd`` of
          the path lengths ``vmap``ped over all grid times;
        - ``lMT, vMT`` (G, nm), the path lengths and their rates;
        - ``Gc`` (G, nphi, nq), the constraint Jacobian, if any.

        The residual at a grid point is then
        ``tau_net + R^T F_m - tau_ctrl(x) + Gc^T lam``: no kinematics is
        left in the NLP functions."""
        q, u, udot = self.position_motion(p, t)
        nm = len(self.muscles)
        G = q.shape[0]
        if nm:
            lMT, vMT = self.muscle_path_kinematics(p, q, u)
            R = torch.func.vmap(torch.func.jacfwd(
                lambda qq: self.path_lengths(p, qq)))(q)
        else:
            lMT = vMT = q.new_zeros((G, 0))
            R = q.new_zeros((G, 0, self.nq))
        x0 = q.new_zeros((G, len(self.control_names())))
        z0 = q.new_zeros((G, self.naux))
        tau_passive = self.applied_generalized_forces(
            p, t, q, u, z0, x0, include_muscles=False,
            include_controls=False)
        tau_net = self.mech.rnea(p["mech"], q, u, udot) - tau_passive
        out = {"t": t, "q": q, "u": u, "udot": udot, "tau_net": tau_net,
               "R": R, "lMT": lMT, "vMT": vMT}
        if self.nphi:
            out["Gc"] = self.constraint_jacobian(p, q)
        return out

    def prescribed_residual_cached(self, p, c, z, x, lam):
        """The force balance at every grid point from the constants ``c``
        of :meth:`prescribed_point_constants`; z (..., G, naux), x
        (..., G, nx), lam (..., G, nphi) (JAX ``models/model.py:1174``)."""
        res = c["tau_net"] - self.tau_controls(p, x)
        if self.muscles:
            _, act, ft = self._muscle_vec_state(z, x)
            F_m = self._muscle_forces_vec(p, act, ft, c["lMT"], c["vMT"])
            res = res + (c["R"] * F_m.unsqueeze(-1)).sum(-2)
        if self.nphi:
            res = res + (c["Gc"] * lam.unsqueeze(-1)).sum(-2)
        return res

    def aux_dynamics(self, p, t, q, u, z, x, implicit_aux_derivs=None,
                     path_kin=None):
        """zdot (..., naux). Implicit-tendon muscles take their derivative
        from ``implicit_aux_derivs`` (the transcription's zeta variables);
        ``path_kin=(lMT, vMT)`` skips the path-kinematics recompute."""
        if self.naux == 0:
            return q.new_zeros(q.shape[:-1] + (0,))
        mv_ = self._mv
        mp = p["muscles"]
        exc, act, ft = self._muscle_vec_state(z, x)
        cols = [None] * self.naux
        act_m = np.nonzero(mv_["act_from_z"])[0]
        if act_m.size:
            dadt = dgf.activation_dynamics(
                _take(exc, act_m), _take(act, act_m),
                _take(mp["activation_time_constant"], act_m),
                _take(mp["deactivation_time_constant"], act_m))
            for k, i in enumerate(act_m):
                cols[mv_["act_zidx"][i]] = dadt[..., k]
        exp_m = np.nonzero(~mv_["rigid"] & ~mv_["implicit"])[0]
        if exp_m.size:
            lMT, vMT = (path_kin if path_kin is not None
                        else self.muscle_path_kinematics(p, q, u))
            dft_exp = dgf.explicit_tendon_dynamics(
                _take_params(mp, exp_m), _take(act, exp_m),
                _take(ft, exp_m), _take(lMT, exp_m), _take(vMT, exp_m),
                mv_["nopass"][exp_m])
            for k, i in enumerate(exp_m):
                cols[mv_["ft_zidx"][i]] = dft_exp[..., k]
        for i in np.nonzero(mv_["implicit"])[0]:
            cols[mv_["ft_zidx"][i]] = (
                implicit_aux_derivs[..., mv_["imp_didx"][i]]
                if implicit_aux_derivs is not None
                else torch.zeros_like(ft[..., i]))
        return torch.stack(torch.broadcast_tensors(*cols), -1)

    def implicit_aux_residuals(self, p, t, q, u, z, x, implicit_aux_derivs,
                               path_kin=None):
        """Equilibrium residuals of implicit-tendon muscles, normalized by
        max isometric force."""
        if not self._implicit_aux:
            return q.new_zeros(q.shape[:-1] + (0,))
        mv_ = self._mv
        imp_m = np.nonzero(mv_["implicit"])[0]
        mps = _take_params(p["muscles"], imp_m)
        exc, act, ft = self._muscle_vec_state(z, x)
        lMT, vMT = (path_kin if path_kin is not None
                    else self.muscle_path_kinematics(p, q, u))
        zeta = _take(implicit_aux_derivs, mv_["imp_didx"][imp_m])
        r = dgf.implicit_tendon_residual(
            mps, _take(act, imp_m), _take(ft, imp_m), zeta,
            _take(lMT, imp_m), _take(vMT, imp_m), mv_["nopass"][imp_m])
        return r / mps["max_isometric_force"]
