"""Goals on the port's main path.

Counterparts of the goals in ``opensim_moco_tpu.ocp.goals``, same fields
and semantics. A goal's ``integrand`` is evaluated on the whole grid at
once: ``t`` is (..., G), ``y`` (..., G, ny), ``x`` (..., G, nx). ``value``
combines endpoint tuples ``(t, y, x, lam, deriv)`` (leading dims only)
with the quadrature of the integrand. A goal is a cost term or, in
``"endpoint_constraint"`` mode, a set of constraint rows (``values``).

Reference trajectories (the tracking goals and ``ContactTrackingGoal``)
are interpolated linearly, clamped at the ends (``jnp.interp`` in the JAX
package), from tables moved to the device once per (device, dtype).

Of the JAX package's goals only ``JointReactionGoal`` is not ported yet:
it needs the joint reactions (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

import numpy as np
import torch

from ..models import muscle as dgf
from ..models.mech import StationSpec, _const_vec
from ..models.spatial import mv
from ..utils.splines import _Coefficients, _rows


class _LinearTable:
    """Linear interpolation of samples ``values`` (K,) or (K, d) at times
    ``times`` (K,), increasing, with the end values held outside: the
    function of ``jnp.interp`` (a repeated time is a step), on a time
    tensor of any leading shape."""

    def __init__(self, times, values):
        x = np.ascontiguousarray(times, dtype=np.float64)
        y = np.ascontiguousarray(values, dtype=np.float64)
        dx = np.diff(x).reshape((-1,) + (1,) * (y.ndim - 1))
        flat = np.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
        slope = np.diff(y, axis=0) / np.where(flat, 1.0, dx)
        self._c = _Coefficients(x=x, y=y,
                                slope=np.where(flat, 0.0, slope))

    def __call__(self, t):
        c = self._c.on(t)
        x, y = c["x"], c["y"]
        i = torch.clamp(torch.searchsorted(x, t.contiguous(), right=True), 1,
                        len(x) - 1) - 1
        dt = t - _rows(x, i)
        if y.dim() > 1:
            dt, t = dt.unsqueeze(-1), t.unsqueeze(-1)
        f = _rows(y, i) + dt * _rows(c["slope"], i)
        f = torch.where(t < x[0], y[0], f)
        return torch.where(t > x[-1], y[-1], f)


def _tables(goal, reference):
    """The goal's reference tables, built on first use."""
    if goal._tables is None:
        goal._tables = {key: _LinearTable(*ref)
                        for key, ref in reference.items()}
    return goal._tables


def _com_displacement(rep, initial, final, p):
    """The smoothed norm sqrt(|com(qf) - com(q0)|^2 + 1e-16) of the
    system's center-of-mass displacement between the endpoints: finite
    gradient at zero displacement (the cold bounds-midpoint guess has
    q0 == qf), where the norm's own is NaN. The mechanical parameters are
    ``p["mech"]`` where ``p`` holds them (JAX ``ocp/goals.py:285``)."""
    mech = rep.model.mech
    mech_p = p["mech"] if isinstance(p, dict) and "mech" in p else p
    diff = (mech.mass_center(mech_p, final[1][..., :mech.nq]) -
            mech.mass_center(mech_p, initial[1][..., :mech.nq]))
    return torch.sqrt((diff * diff).sum(-1) + 1e-16)


@dataclasses.dataclass
class Goal:
    name: str = "goal"
    weight: float = 1.0
    mode: str = "cost"  # "cost" | "endpoint_constraint"
    # bounds for endpoint-constraint mode (per output element)
    constraint_bounds: tuple = (0.0, 0.0)
    divide_by_duration: bool = False
    # number of outputs in endpoint-constraint mode
    num_outputs: int = 1

    def hessian_block_local(self) -> bool:
        """True iff this goal's cost-mode ``value`` adds no cross-time-block
        curvature to the Lagrangian Hessian: it is affine in the integral
        (whose integrand is per grid point) plus any function of border
        variables and of grid points within one time block. The structured
        KKT path compresses the Hessian assuming block-diagonal + border
        sparsity, so ``Transcription.kkt_structure`` returns None (dense
        path) unless every cost goal reports True.

        Conservative default: a goal that does not override :meth:`value`
        is safe; an override is unsafe unless the subclass sets
        ``_VALUE_BLOCK_LOCAL = True`` or overrides this method."""
        if type(self).value is Goal.value:
            return True
        return bool(getattr(type(self), "_VALUE_BLOCK_LOCAL", False))

    def integrand(self, rep, t, y, x, lam, p):
        return torch.zeros_like(t)

    def value(self, rep, initial, final, integral, p):
        """Default: the integral itself (over the duration if
        ``divide_by_duration``)."""
        val = integral
        if self.divide_by_duration:
            val = val / (final[0] - initial[0])
        return val


@dataclasses.dataclass
class ControlGoal(Goal):
    """Sum_i w_i |x_i|^p integrated over time (MocoControlGoal). Weights by
    control name or regex pattern. With ``divide_by_displacement`` the
    integral (over the duration if asked) is divided by the norm of the
    system's center-of-mass displacement between the endpoints: effort
    over distance, as predictive gait problems pose it (JAX
    ``ocp/goals.py:90``)."""
    name: str = "control_effort"
    exponent: int = 2
    control_weights: dict = dataclasses.field(default_factory=dict)
    pattern_weights: dict = dataclasses.field(default_factory=dict)
    divide_by_displacement: bool = False

    def value(self, rep, initial, final, integral, p):
        val = super().value(rep, initial, final, integral, p)
        if self.divide_by_displacement:
            val = val / _com_displacement(rep, initial, final, p)
        return val

    def hessian_block_local(self) -> bool:
        # dividing the integral by a nonlinear function of the endpoint
        # states couples every block's curvature with the first and last
        return not self.divide_by_displacement

    def _weights(self, control_names):
        w = np.ones(len(control_names))
        for pat, pw in self.pattern_weights.items():
            for i, cn in enumerate(control_names):
                if re.fullmatch(pat, cn):
                    w[i] = pw
        for cn, cw in self.control_weights.items():
            w[control_names.index(cn)] = cw
        return w

    def integrand(self, rep, t, y, x, lam, p):
        w = self._weights(rep.control_names)
        terms = x * x if self.exponent == 2 else x.abs() ** self.exponent
        if np.all(w == 1.0):
            return terms.sum(-1)
        return sum(float(wi) * terms[..., i] for i, wi in enumerate(w))


@dataclasses.dataclass
class FinalTimeGoal(Goal):
    """Minimize the final time (MocoFinalTimeGoal)."""
    name: str = "final_time"
    _VALUE_BLOCK_LOCAL = True  # value reads a border variable (tf) only

    def value(self, rep, initial, final, integral, p):
        return final[0]


@dataclasses.dataclass
class InitialActivationGoal(Goal):
    """sum_i (excitation_i(t0) - activation_i(t0))^2
    (MocoInitialActivationGoal)."""
    name: str = "initial_activation"
    _VALUE_BLOCK_LOCAL = True  # value reads the initial grid point only

    def value(self, rep, initial, final, integral, p):
        y0 = initial[1]
        x0 = initial[2]
        total = torch.zeros_like(y0[..., 0])
        m = rep.model
        aux0 = 0 if m.prescribed else 2 * m.nq  # JAX ocp/goals.py:258
        mus_idx = {ms.name: mi for mi, ms in enumerate(m.muscles)}
        for k, (mname, kind) in enumerate(m._aux_index):
            if kind == "activation":
                exc = x0[..., len(m.actuators) + mus_idx[mname]]
                total = total + (exc - y0[..., aux0 + k]) ** 2
        return total


@dataclasses.dataclass
class StateTrackingGoal(Goal):
    """Weighted squared tracking of reference state trajectories
    (MocoStateTrackingGoal; JAX ``ocp/goals.py:140``). ``reference`` maps a
    state name to (times (K,), values (K,)), interpolated linearly. Its
    integrand is per grid point (the default ``hessian_block_local``)."""
    name: str = "state_tracking"
    reference: dict = dataclasses.field(default_factory=dict)
    state_weights: dict = dataclasses.field(default_factory=dict)
    scale_by_range: bool = False
    _tables: dict | None = dataclasses.field(default=None, init=False,
                                             repr=False, compare=False)

    def integrand(self, rep, t, y, x, lam, p):
        tables = _tables(self, self.reference)
        total = torch.zeros_like(t)
        for name, (times, values) in self.reference.items():
            i = rep.state_names.index(name)
            w = self.state_weights.get(name, 1.0)
            if self.scale_by_range:
                rng = float(np.max(values) - np.min(values))
                if rng > 1e-12:
                    w = w / rng ** 2
            total = total + w * (y[..., i] - tables[name](t)) ** 2
        return total


@dataclasses.dataclass
class MarkerTrackingGoal(Goal):
    """Weighted squared distance of model markers from their reference
    trajectories (MocoMarkerTrackingGoal; JAX ``ocp/goals.py:327``).
    ``markers`` maps a marker name to (body index, location in the body
    frame), ``reference`` a marker name to (times (K,), positions (K, 3)),
    interpolated linearly per component on that marker's own times, and
    ``marker_weights`` a marker name to its weight (default 1). The
    markers are summed in the dict's order. Its integrand is per grid
    point (the default ``hessian_block_local``)."""
    name: str = "marker_tracking"
    markers: dict = dataclasses.field(default_factory=dict)
    reference: dict = dataclasses.field(default_factory=dict)
    marker_weights: dict = dataclasses.field(default_factory=dict)
    _tables: dict | None = dataclasses.field(default=None, init=False,
                                             repr=False, compare=False)

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        tables = _tables(self, self.reference)
        # one pass over the tree for every marker
        pos = m.mech.station_positions(
            p["mech"], y[..., :m.nq],
            [StationSpec(name, body, tuple(loc))
             for name, (body, loc) in self.markers.items()])
        total = torch.zeros_like(t)
        for k, name in enumerate(self.markers):
            err = pos[..., k, :] - tables[name](t)
            total = total + self.marker_weights.get(name, 1.0) * \
                (err * err).sum(-1)
        return total


@dataclasses.dataclass
class SumSquaredStateGoal(Goal):
    """Sum of squared state values, with an optional name regex and
    per-state weights (MocoSumSquaredStateGoal; JAX ``ocp/goals.py:165``).
    Its integrand is per grid point, so its curvature stays in the time
    blocks (the default ``hessian_block_local``)."""
    name: str = "sum_squared_state"
    pattern: str = ".*"
    state_weights: dict = dataclasses.field(default_factory=dict)

    def integrand(self, rep, t, y, x, lam, p):
        total = torch.zeros_like(t)
        for i, sn in enumerate(rep.state_names):
            if re.fullmatch(self.pattern, sn):
                w = self.state_weights.get(sn, 1.0)
                total = total + w * y[..., i] ** 2
        return total


@dataclasses.dataclass
class PeriodicityGoal(Goal):
    """Equal (or, with ``negate``, opposite) initial and final values of
    states and controls (MocoPeriodicityGoal; JAX ``ocp/goals.py:203``).
    A pair is ``name``, ``(name, negate)`` or
    ``(name_initial, name_final, negate)``. In its default
    ``"endpoint_constraint"`` mode each pair is a constraint row, which
    the structured KKT path puts in the border; as a cost, the sum of the
    squared pair errors couples the first and last time blocks, so the
    problem takes the dense KKT path, as in the JAX package."""
    name: str = "periodicity"
    mode: str = "endpoint_constraint"
    state_pairs: tuple = ()
    control_pairs: tuple = ()

    def __post_init__(self):
        self.num_outputs = len(self.state_pairs) + len(self.control_pairs)

    @staticmethod
    def _pair(names, pair):
        if len(pair) == 2 and isinstance(pair[1], bool):
            a = b = pair[0]
            negate = pair[1]
        elif isinstance(pair, str):
            a = b = pair
            negate = False
        else:
            a, b, negate = pair
        return names.index(a), names.index(b), negate

    def values(self, rep, initial, final, p):
        out = []
        y0, x0 = initial[1], initial[2]
        yf, xf = final[1], final[2]
        for pairs, names, v0, vf in (
                (self.state_pairs, rep.state_names, y0, yf),
                (self.control_pairs, rep.control_names, x0, xf)):
            for pair in pairs:
                i, j, negate = self._pair(names, pair)
                out.append(vf[..., j] + v0[..., i] if negate
                           else vf[..., j] - v0[..., i])
        if not out:
            return y0.new_zeros(y0.shape[:-1] + (0,))
        return torch.stack(out, -1)

    def value(self, rep, initial, final, integral, p):
        v = self.values(rep, initial, final, p)
        return (v * v).sum(-1)


@dataclasses.dataclass
class ContactTrackingGoal(Goal):
    """Track ground reaction forces with groups of contact components
    (MocoContactTrackingGoal; JAX ``ocp/goals.py:474``). ``groups`` is a
    tuple of (contact_names, ref_key); ``reference`` maps ref_key to
    (times (K,), forces (K, 3)) in ground. The squared error is divided by
    the model's weight (total mass times |g|) and optionally projected
    (``projection``: "none", "vector" onto ``projection_vector``, or
    "plane" orthogonal to it). Its integrand is per grid point (the
    default ``hessian_block_local``)."""
    name: str = "contact_tracking"
    groups: tuple = ()
    reference: dict = dataclasses.field(default_factory=dict)
    projection: str = "none"
    projection_vector: tuple = (0.0, 1.0, 0.0)
    _tables: dict | None = dataclasses.field(default=None, init=False,
                                             repr=False, compare=False)

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        q = y[..., :m.nq]
        u = y[..., m.nq:2 * m.nq]
        forces = m.contact_forces(p, t, q, u)
        tables = _tables(self, self.reference)
        mech = p["mech"]
        denom = mech["mass"].sum() * torch.sqrt(
            (mech["gravity"] * mech["gravity"]).sum())
        v = np.asarray(self.projection_vector, dtype=np.float64)
        v = v / np.linalg.norm(v)
        total = torch.zeros_like(t)
        for names, ref_key in self.groups:
            f_model = sum(forces[n] for n in names)
            err = f_model - tables[ref_key](t)
            if self.projection in ("vector", "plane"):
                along = sum(float(vk) * err[..., k] for k, vk in enumerate(v)
                            if vk != 0.0)
                proj = torch.stack([along * float(vk) for vk in v], -1)
                err = proj if self.projection == "vector" else err - proj
            total = total + (err * err).sum(-1)
        return total / denom


class _InitialMuscleEquilibrium(Goal):
    """Shared plumbing of the two initial-equilibrium goals: one residual
    per compliant-tendon muscle, stacked on the last dim."""
    _VALUE_BLOCK_LOCAL = True  # value reads the initial grid point only

    def auto_outputs(self, rep):
        return sum(1 for m in rep.model.muscles
                   if not m.ignore_tendon_compliance)

    def _residual(self, m, mi, mp, act, ft, lMT, vMT, d0):
        raise NotImplementedError

    def _residuals(self, rep, initial, p):
        m = rep.model
        y0, x0 = initial[1], initial[2]
        d0 = initial[4] if len(initial) > 4 else None
        q, u, z = m.split_state(y0)
        lMT, vMT = m.muscle_path_kinematics(p, q, u)
        res = []
        for mi, mspec in enumerate(m.muscles):
            if mspec.ignore_tendon_compliance:
                continue
            mp = {k: v[mi] for k, v in p["muscles"].items()}
            act, ft = m.muscle_state(z, x0, mi)
            r = self._residual(m, mi, mp, act, ft, lMT[..., mi],
                               vMT[..., mi], d0)
            res.append(r / mp["max_isometric_force"])
        if not res:
            return y0.new_zeros(y0.shape[:-1] + (0,))
        return torch.stack(res, -1)

    def values(self, rep, initial, final, p):
        return self._residuals(rep, initial, p)

    def value(self, rep, initial, final, integral, p):
        r = self._residuals(rep, initial, p)
        return (r * r).sum(-1)


@dataclasses.dataclass
class InitialVelocityEquilibriumDGFGoal(_InitialMuscleEquilibrium):
    """Velocity-level DGF muscle-tendon equilibrium at the initial time
    (MocoInitialVelocityEquilibriumDGFGoal): per compliant-tendon muscle,
    the derivative of the linearized equilibrium residual. Reads the
    initial tendon-force derivative variables for implicit tendons."""
    name: str = "initial_velocity_equilibrium"
    mode: str = "endpoint_constraint"

    def _residual(self, m, mi, mp, act, ft, lMT, vMT, d0):
        mspec = m.muscles[mi]
        dft = torch.zeros_like(ft)
        if mspec.tendon_dynamics_implicit and d0 is not None \
                and d0.shape[-1]:
            # derivative block layout [udot (implicit mb) | zeta]: zeta
            # always occupies the tail
            didx = int(m._mv["imp_didx"][mi])
            dft = d0[..., d0.shape[-1] - m.n_implicit_aux + didx]
        return dgf.linearized_equilibrium_residual_derivative(
            mp, act, ft, dft, lMT, vMT,
            mspec.ignore_passive_fiber_force or None)


@dataclasses.dataclass
class InitialForceEquilibriumGoal(_InitialMuscleEquilibrium):
    """Muscle-tendon force equilibrium at the initial time for
    compliant-tendon muscles (MocoInitialForceEquilibriumGoal)."""
    name: str = "initial_force_equilibrium"

    def _residual(self, m, mi, mp, act, ft, lMT, vMT, d0):
        return dgf.implicit_tendon_residual(
            mp, act, ft, 0.0, lMT, vMT,
            m.muscles[mi].ignore_passive_fiber_force or None)


@dataclasses.dataclass
class CustomGoal(Goal):
    """Arbitrary integrand/endpoint closures (JAX ``ocp/goals.py:301``).
    ``integrand_fn(rep, t, y, x, lam, p)`` and
    ``value_fn(rep, initial, final, integral, p)`` take the port's batched
    tensors. A ``value_fn`` in cost mode may couple any points, so it sends
    the problem to the dense KKT path, as in the JAX package.

    In ``"endpoint_constraint"`` mode ``value_fn`` gives the constraint
    values, (...) or (..., num_outputs), and is called with
    ``integral=None`` (endpoint rows have no quadrature); the JAX package's
    goal has no such mode."""
    name: str = "custom"
    integrand_fn: Callable | None = None
    value_fn: Callable | None = None

    def hessian_block_local(self):
        return self.value_fn is None

    def integrand(self, rep, t, y, x, lam, p):
        if self.integrand_fn is None:
            return torch.zeros_like(t)
        return self.integrand_fn(rep, t, y, x, lam, p)

    def value(self, rep, initial, final, integral, p):
        if self.value_fn is None:
            return super().value(rep, initial, final, integral, p)
        return self.value_fn(rep, initial, final, integral, p)

    def values(self, rep, initial, final, p):
        if self.value_fn is None:
            raise ValueError(f"CustomGoal {self.name!r}: endpoint-constraint "
                             "mode needs a value_fn")
        vals = self.value_fn(rep, initial, final, None, p)
        if vals.dim() == initial[0].dim():
            vals = vals.unsqueeze(-1)
        return vals


@dataclasses.dataclass
class AverageSpeedGoal(Goal):
    """Average speed over the phase minus ``desired_speed``
    (MocoAverageSpeedGoal; JAX ``ocp/goals.py:267``): with ``use_com``
    the speed is the norm of the center-of-mass displacement over the
    duration (the reference's semantics), else the displacement of
    coordinate ``coord`` over the duration. One constraint row in its
    default ``"endpoint_constraint"`` mode; as a cost its square, which
    couples the first and last grid points, so the problem then takes
    the dense KKT path."""
    name: str = "average_speed"
    mode: str = "endpoint_constraint"
    coord: int = 0
    desired_speed: float = 0.0
    use_com: bool = False

    def values(self, rep, initial, final, p):
        t0, y0 = initial[0], initial[1]
        tf, yf = final[0], final[1]
        if self.use_com:
            avg = _com_displacement(rep, initial, final, p) / (tf - t0)
        else:
            avg = (yf[..., self.coord] - y0[..., self.coord]) / (tf - t0)
        return (avg - self.desired_speed).unsqueeze(-1)

    def value(self, rep, initial, final, integral, p):
        return self.values(rep, initial, final, p)[..., 0] ** 2


@dataclasses.dataclass
class MarkerFinalGoal(Goal):
    """Squared distance (or, without ``squared``, the smoothed distance
    sqrt(d^2 + 1e-16)) of a point fixed in ``body`` from ``target`` at the
    final time (MocoMarkerFinalGoal; JAX ``ocp/goals.py:181``)."""
    name: str = "marker_final"
    _VALUE_BLOCK_LOCAL = True  # value reads the final grid point only
    body: int = 0
    location: tuple = (0.0, 0.0, 0.0)
    target: tuple = (0.0, 0.0, 0.0)
    squared: bool = True

    def value(self, rep, initial, final, integral, p):
        yf = final[1]
        m = rep.model
        pos = m.mech.station_position(p["mech"], yf[..., :m.nq], self.body,
                                      self.location)
        err = pos - _const_vec(self.target, pos)
        d2 = (err * err).sum(-1)
        return d2 if self.squared else torch.sqrt(d2 + 1e-16)


@dataclasses.dataclass
class ControlTrackingGoal(Goal):
    """Weighted squared tracking of reference control trajectories
    (MocoControlTrackingGoal; JAX ``ocp/goals.py:355``). ``reference``
    maps a control name to (times (K,), values (K,))."""
    name: str = "control_tracking"
    reference: dict = dataclasses.field(default_factory=dict)
    control_weights: dict = dataclasses.field(default_factory=dict)
    _tables: dict | None = dataclasses.field(default=None, init=False,
                                             repr=False, compare=False)

    def integrand(self, rep, t, y, x, lam, p):
        tables = _tables(self, self.reference)
        total = torch.zeros_like(t)
        for name in self.reference:
            i = rep.control_names.index(name)
            w = self.control_weights.get(name, 1.0)
            total = total + w * (x[..., i] - tables[name](t)) ** 2
        return total


@dataclasses.dataclass
class TranslationTrackingGoal(Goal):
    """Squared error of body origins in the world against their reference
    positions (MocoTranslationTrackingGoal; JAX ``ocp/goals.py:375``).
    ``reference`` maps a body index to (times (K,), positions (K, 3))."""
    name: str = "translation_tracking"
    reference: dict = dataclasses.field(default_factory=dict)
    _tables: dict | None = dataclasses.field(default=None, init=False,
                                             repr=False, compare=False)

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        frames = m.mech.frames(p["mech"], y[..., :m.nq])
        tables = _tables(self, self.reference)
        total = torch.zeros_like(t)
        for body in self.reference:
            err = frames[body][1] - tables[body](t)
            total = total + (err * err).sum(-1)
        return total


@dataclasses.dataclass
class OrientationTrackingGoal(Goal):
    """Frobenius error of body rotation matrices against their references
    (MocoOrientationTrackingGoal measures a quaternion distance; JAX
    ``ocp/goals.py:398``). ``reference`` maps a body index to (times (K,),
    rotation matrices (K, 3, 3), world to body), interpolated entry by
    entry."""
    name: str = "orientation_tracking"
    reference: dict = dataclasses.field(default_factory=dict)
    _tables: dict | None = dataclasses.field(default=None, init=False,
                                             repr=False, compare=False)

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        frames = m.mech.frames(p["mech"], y[..., :m.nq])
        if self._tables is None:
            self._tables = {
                body: _LinearTable(times, np.reshape(mats, (len(mats), 9)))
                for body, (times, mats) in self.reference.items()}
        total = torch.zeros_like(t)
        for body in self.reference:
            ref = self._tables[body](t).reshape(t.shape + (3, 3))
            err = frames[body][0] - ref
            total = total + (err * err).sum((-2, -1))
        return total


@dataclasses.dataclass
class AngularVelocityTrackingGoal(Goal):
    """Squared error of body angular velocities in the world against their
    references (MocoAngularVelocityTrackingGoal; JAX
    ``ocp/goals.py:425``). ``reference`` maps a body index to (times (K,),
    angular velocities (K, 3)). With A the world-to-body rotation and
    Adot its rate (the ``jvp`` of the poses along u), W = Adot A^T is
    -skew(omega) in body coordinates, and omega_world = A^T omega."""
    name: str = "angular_velocity_tracking"
    reference: dict = dataclasses.field(default_factory=dict)
    _tables: dict | None = dataclasses.field(default=None, init=False,
                                             repr=False, compare=False)

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        bodies = list(self.reference)

        def rotations(qq):
            frames = m.mech.frames(p["mech"], qq)
            return tuple(frames[b][0] for b in bodies)

        rots, rates = torch.func.jvp(rotations, (y[..., :m.nq],),
                                     (y[..., m.nq:2 * m.nq],))
        tables = _tables(self, self.reference)
        total = torch.zeros_like(t)
        for body, A, Adot in zip(bodies, rots, rates):
            W = Adot @ A.transpose(-1, -2)
            omega = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]],
                                -1)
            err = mv(A.transpose(-1, -2), -omega) - tables[body](t)
            total = total + (err * err).sum(-1)
        return total


@dataclasses.dataclass
class OutputGoal(Goal):
    """Minimize any model quantity given as a closure (MocoOutputGoal; JAX
    ``ocp/goals.py:460``): ``output_fn(rep, t, y, x, lam, p)`` takes the
    port's grid tensors (``t`` (..., G), ``y`` (..., G, ny), ...) and
    returns (..., G); the integrand is its ``exponent``-th power."""
    name: str = "output"
    output_fn: Callable | None = None
    exponent: int = 1

    def integrand(self, rep, t, y, x, lam, p):
        v = self.output_fn(rep, t, y, x, lam, p)
        return v ** self.exponent if self.exponent != 1 else v


@dataclasses.dataclass
class AccelerationTrackingGoal(Goal):
    """Squared error of body-origin linear accelerations in the world
    against their references (MocoAccelerationTrackingGoal; JAX
    ``ocp/goals.py:518``). ``reference`` maps a body index to (times (K,),
    accelerations (K, 3)). The accelerations come from explicit forward
    dynamics at each grid point (udot), as the second derivative of the
    origin along (u, udot): two nested ``jvp``s. ``gravity_offset``
    subtracts gravity, as an accelerometer reads."""
    name: str = "acceleration_tracking"
    reference: dict = dataclasses.field(default_factory=dict)
    gravity_offset: bool = False
    _tables: dict | None = dataclasses.field(default=None, init=False,
                                             repr=False, compare=False)

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        q, u, z = m.split_state(y)
        udot = m.multibody_explicit(p, t, q, u, z, x, lam)
        bodies = list(self.reference)

        def origins(qq):
            frames = m.mech.frames(p["mech"], qq)
            return torch.stack([frames[b][1] for b in bodies], -2)

        def velocities(qq, uu):
            return torch.func.jvp(origins, (qq,), (uu,))[1]

        acc = torch.func.jvp(velocities, (q, u), (u, udot))[1]
        if self.gravity_offset:
            acc = acc - p["mech"]["gravity"]
        tables = _tables(self, self.reference)
        total = torch.zeros_like(t)
        for k, body in enumerate(bodies):
            err = acc[..., k, :] - tables[body](t)
            total = total + (err * err).sum(-1)
        return total


@dataclasses.dataclass
class JointReactionGoal(Goal):
    """Minimize one joint's reaction loads (MocoJointReactionGoal; JAX
    ``ocp/goals.py:556``): the integrand is sum_i w_i r_i^2 over the
    selected measures of the reaction on the joint's child body, in the
    world (:meth:`Model.joint_reaction`, udot from the explicit forward
    dynamics). ``joint`` is the child body's index; ``measures`` picks
    from ("moment-x", "moment-y", "moment-z", "force-x", "force-y",
    "force-z"). As in the JAX package, ``y`` is read as [q, u, z]."""
    name: str = "joint_reaction"
    joint: int = 0
    measures: tuple = ("moment-x", "moment-y", "moment-z",
                       "force-x", "force-y", "force-z")
    measure_weights: dict = dataclasses.field(default_factory=dict)

    _IDX = {"moment-x": 0, "moment-y": 1, "moment-z": 2,
            "force-x": 3, "force-y": 4, "force-z": 5}

    def integrand(self, rep, t, y, x, lam, p):
        m = rep.model
        q, u, z = m.split_state(y)
        reac = m.joint_reaction(p, t, q, u, z, x, lam)[..., self.joint, :]
        total = torch.zeros_like(t)
        for meas in self.measures:
            w = self.measure_weights.get(meas, 1.0)
            total = total + w * reac[..., self._IDX[meas]] ** 2
        return total
