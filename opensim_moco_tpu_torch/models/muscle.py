"""DeGrooteFregly2016 muscle model in PyTorch.

Counterpart of ``opensim_moco_tpu.models.muscle``; the curve constants and
formulas are the same (reference DeGrooteFregly2016Muscle.h:764-817 and
.cpp:186-380). All functions are elementwise over muscles and over any
leading dimensions: pass per-muscle parameter tensors of shape ``(nm,)``
(or scalars for one muscle) and state tensors of shape ``(..., nm)``.

Parameter builders return numpy; the model moves them to a device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# Active force-length curve constants (DeGrooteFregly2016Muscle.h:769-780).
B11 = 0.8150671134243542
B21 = 1.055033428970575
B31 = 0.162384573599574
B41 = 0.063303448465465
B12 = 0.433004984392647
B22 = 0.716775413397760
B32 = -0.029947116970696
B42 = 0.200356847296188
B13 = 0.1
B23 = 1.0
B33 = 0.353553390593274  # 0.5 * sqrt(0.5)
B43 = 0.0

# Passive force-length exponential shape factor (h:785).
KPE = 4.0

# Tendon force-length constants (h:789-798).
C1 = 0.200
C2 = 1.0
C3 = 0.200

# Force-velocity constants (h:808-811).
D1 = -0.3211346127989808
D2 = -8.149
D3 = -0.374
D4 = 0.8825327733249912

MIN_NORM_FIBER_LENGTH = 0.2
MAX_NORM_FIBER_LENGTH = 1.8
MIN_NORM_TENDON_FORCE = 0.0
MAX_NORM_TENDON_FORCE = 5.0

TANH_STEEPNESS = 0.1  # activation-dynamics switching (cpp:195)


def default_muscle_params(max_isometric_force=1000.0,
                          optimal_fiber_length=0.1,
                          tendon_slack_length=0.2,
                          pennation_angle_at_optimal=0.0,
                          max_contraction_velocity=10.0,
                          activation_time_constant=0.015,
                          deactivation_time_constant=0.060,
                          active_force_width_scale=1.0,
                          fiber_damping=0.0,
                          passive_fiber_strain_at_one_norm_force=0.6,
                          tendon_strain_at_one_norm_force=0.049):
    """Parameter dict for one muscle, as numpy float64 scalars. Defaults
    mirror DeGrooteFregly2016Muscle::constructProperties."""
    return {
        "max_isometric_force": np.float64(max_isometric_force),
        "optimal_fiber_length": np.float64(optimal_fiber_length),
        "tendon_slack_length": np.float64(tendon_slack_length),
        "pennation_angle_at_optimal": np.float64(pennation_angle_at_optimal),
        "max_contraction_velocity": np.float64(max_contraction_velocity),
        "activation_time_constant": np.float64(activation_time_constant),
        "deactivation_time_constant": np.float64(deactivation_time_constant),
        "active_force_width_scale": np.float64(active_force_width_scale),
        "fiber_damping": np.float64(fiber_damping),
        "passive_fiber_strain_at_one_norm_force":
            np.float64(passive_fiber_strain_at_one_norm_force),
        "tendon_strain_at_one_norm_force":
            np.float64(tendon_strain_at_one_norm_force),
    }


def stack_muscle_params(params_list):
    """Stack per-muscle parameter dicts into numpy arrays of shape (n,)."""
    keys = params_list[0].keys()
    return {k: np.stack([np.asarray(p[k], dtype=np.float64)
                         for p in params_list]) for k in keys}


# ----------------------------------------------------------------- curves

def _exp(x):
    """exp of a tensor or of a plain number (a default curve constant)."""
    return torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)


def _gaussian_like(x, b1, b2, b3, b4):
    # DeGrooteFregly2016Muscle.h:720-725 (note squared denominator).
    return b1 * torch.exp(-0.5 * (x - b2) ** 2 / (b3 + b4 * x) ** 2)


def active_force_length(norm_fiber_length, width_scale=1.0):
    """Sum of 3 Gaussian-like curves; f(1) = 1 (h:329-341)."""
    x = (norm_fiber_length - 1.0) / width_scale + 1.0
    return (_gaussian_like(x, B11, B21, B31, B41) +
            _gaussian_like(x, B12, B22, B32, B42) +
            _gaussian_like(x, B13, B23, B33, B43))


def force_velocity(norm_fiber_velocity):
    """fv multiplier; fv(-1)=0, fv(0)=1 (h:360-370)."""
    tempV = D2 * norm_fiber_velocity + D3
    tempLogArg = tempV + torch.sqrt(tempV ** 2 + 1.0)
    return D1 * torch.log(tempLogArg) + D4


def force_velocity_inverse(fv_multiplier):
    """Inverse of force_velocity (h:372-381)."""
    return (torch.sinh(1.0 / D1 * (fv_multiplier - D4)) - D3) / D2


def passive_force_length(norm_fiber_length, e0=0.6, ignore=None):
    """Passive fiber force; zero at norm length 0.2 (h:383-405).

    ``ignore``: None, or a static per-muscle bool sequence; muscles marked
    True get zero passive force (ModOpIgnorePassiveFiberForcesDGF)."""
    offset = _exp(KPE * (MIN_NORM_FIBER_LENGTH - 1.0) / e0)
    denom = math.exp(KPE) - offset
    val = (torch.exp(KPE * (norm_fiber_length - 1.0) / e0) - offset) / denom
    if ignore is None or not np.any(ignore):
        return val
    keep = torch.as_tensor(~np.asarray(ignore, dtype=bool),
                           device=val.device)
    return torch.where(keep, val, torch.zeros_like(val))


def tendon_kT(tendon_strain_at_one_norm_force):
    """Tendon exponential stiffness from strain-at-one-norm-force
    (DeGrooteFregly2016Muscle.cpp:140-141)."""
    return math.log((1.0 + C3) / C1) / tendon_strain_at_one_norm_force


def tendon_force_multiplier(norm_tendon_length, kT):
    """Normalized tendon force vs normalized tendon length (h:437-443)."""
    return C1 * torch.exp(kT * (norm_tendon_length - C2)) - C3


def tendon_force_multiplier_derivative(norm_tendon_length, kT):
    return C1 * kT * torch.exp(kT * (norm_tendon_length - C2))


def tendon_force_length_inverse(norm_tendon_force, kT):
    """Normalized tendon length vs normalized tendon force (h:461-465)."""
    return torch.log((1.0 / C1) * (norm_tendon_force + C3)) / kT + C2


def tendon_force_length_inverse_derivative(d_norm_tendon_force,
                                           norm_tendon_length, kT):
    """Normalized tendon velocity from d(normTendonForce)/dt (h:468-475)."""
    return d_norm_tendon_force / (C1 * kT *
                                  torch.exp(kT * (norm_tendon_length - C2)))


# ------------------------------------------------------------- dynamics

def activation_dynamics(excitation, activation, tau_act=0.015,
                        tau_deact=0.060):
    """da/dt with tanh-switched time constants (cpp:186-210)."""
    z = 0.5 + 1.5 * activation
    temp_act = 1.0 / (tau_act * z)
    temp_deact = z / tau_deact
    f = 0.5 * torch.tanh(TANH_STEEPNESS * (excitation - activation))
    time_const = temp_act * (f + 0.5) + temp_deact * (-f + 0.5)
    return time_const * (excitation - activation)


def _fiber_geometry(p, fiber_length_along_tendon):
    """fiber length, normFiberLength, cos/sin pennation from fiber length
    along tendon (cpp:255-268), fixed-width pennation model."""
    lMopt = p["optimal_fiber_length"]
    fiber_width = lMopt * torch.sin(p["pennation_angle_at_optimal"])
    fiber_length = torch.sqrt(fiber_length_along_tendon ** 2 +
                              fiber_width ** 2)
    cos_pen = fiber_length_along_tendon / fiber_length
    sin_pen = fiber_width / fiber_length
    return fiber_length, fiber_length / lMopt, cos_pen, sin_pen


def rigid_tendon_force(p, activation, lMT, vMT,
                       ignore_passive_fiber_force=None):
    """Path force (N) with a rigid tendon: closed form, no state
    (ignoreTendonCompliance branches, cpp:240-380)."""
    lT = p["tendon_slack_length"]
    fiber_len_at = lMT - lT
    fiber_length, norm_fiber_length, cos_pen, sin_pen = _fiber_geometry(
        p, fiber_len_at)
    fiber_vel_at = vMT
    fiber_velocity = fiber_vel_at * cos_pen
    norm_fiber_velocity = fiber_velocity / (
        p["max_contraction_velocity"] * p["optimal_fiber_length"])
    fl_act = active_force_length(norm_fiber_length,
                                 p["active_force_width_scale"])
    fv = force_velocity(norm_fiber_velocity)
    fl_pas = passive_force_length(
        norm_fiber_length, p["passive_fiber_strain_at_one_norm_force"],
        ignore=ignore_passive_fiber_force)
    fmax = p["max_isometric_force"]
    fiber_force = fmax * (activation * fl_act * fv + fl_pas +
                          p["fiber_damping"] * norm_fiber_velocity)
    return fiber_force * cos_pen


def compliant_tendon_state(p, norm_tendon_force, lMT):
    """Geometry shared by the compliant-tendon paths: (norm tendon
    length, fiber length, norm fiber length, cos_pen, sin_pen)."""
    kT = tendon_kT(p["tendon_strain_at_one_norm_force"])
    norm_tendon_length = tendon_force_length_inverse(norm_tendon_force, kT)
    tendon_length = p["tendon_slack_length"] * norm_tendon_length
    fiber_len_at = lMT - tendon_length
    fiber_length, norm_fiber_length, cos_pen, sin_pen = _fiber_geometry(
        p, fiber_len_at)
    return norm_tendon_length, fiber_length, norm_fiber_length, cos_pen, sin_pen


def explicit_tendon_dynamics(p, activation, norm_tendon_force, lMT, vMT,
                             ignore_passive_fiber_force=None):
    """d(normTendonForce)/dt for explicit tendon-compliance dynamics
    (isTendonDynamicsExplicit branch, cpp:285-300)."""
    kT = tendon_kT(p["tendon_strain_at_one_norm_force"])
    (norm_tendon_length, fiber_length, norm_fiber_length, cos_pen,
     sin_pen) = compliant_tendon_state(p, norm_tendon_force, lMT)
    fl_act = active_force_length(norm_fiber_length,
                                 p["active_force_width_scale"])
    fl_pas = passive_force_length(
        norm_fiber_length, p["passive_fiber_strain_at_one_norm_force"],
        ignore=ignore_passive_fiber_force)
    norm_fiber_force = norm_tendon_force / cos_pen
    fv = (norm_fiber_force - fl_pas) / (activation * fl_act)
    norm_fiber_velocity = force_velocity_inverse(fv)
    fiber_velocity = norm_fiber_velocity * (
        p["max_contraction_velocity"] * p["optimal_fiber_length"])
    fiber_vel_at = fiber_velocity / cos_pen
    tendon_velocity = vMT - fiber_vel_at
    norm_tendon_velocity = tendon_velocity / p["tendon_slack_length"]
    return norm_tendon_velocity * tendon_force_multiplier_derivative(
        norm_tendon_length, kT)


def implicit_tendon_residual(p, activation, norm_tendon_force,
                             d_norm_tendon_force, lMT, vMT,
                             ignore_passive_fiber_force=None):
    """Equilibrium residual (N) for implicit tendon-compliance dynamics:
    tendonForce - fiberForceAlongTendon (h:641-646, cpp:826-848)."""
    kT = tendon_kT(p["tendon_strain_at_one_norm_force"])
    (norm_tendon_length, fiber_length, norm_fiber_length, cos_pen,
     sin_pen) = compliant_tendon_state(p, norm_tendon_force, lMT)
    norm_tendon_velocity = tendon_force_length_inverse_derivative(
        d_norm_tendon_force, norm_tendon_length, kT)
    tendon_velocity = p["tendon_slack_length"] * norm_tendon_velocity
    fiber_vel_at = vMT - tendon_velocity
    fiber_velocity = fiber_vel_at * cos_pen
    norm_fiber_velocity = fiber_velocity / (
        p["max_contraction_velocity"] * p["optimal_fiber_length"])
    fl_act = active_force_length(norm_fiber_length,
                                 p["active_force_width_scale"])
    fv = force_velocity(norm_fiber_velocity)
    fl_pas = passive_force_length(
        norm_fiber_length, p["passive_fiber_strain_at_one_norm_force"],
        ignore=ignore_passive_fiber_force)
    fmax = p["max_isometric_force"]
    fiber_force = fmax * (activation * fl_act * fv + fl_pas +
                          p["fiber_damping"] * norm_fiber_velocity)
    fiber_force_at = fiber_force * cos_pen
    tendon_force = fmax * norm_tendon_force
    return tendon_force - fiber_force_at


def tendon_force_from_state(p, norm_tendon_force):
    """Path force (N) applied by a compliant-tendon muscle."""
    return p["max_isometric_force"] * norm_tendon_force


def linearized_equilibrium_residual_derivative(
        p, activation, norm_tendon_force, d_norm_tendon_force, lMT, vMT,
        ignore_passive_fiber_force=None):
    """Time derivative of the linearized muscle-tendon equilibrium
    (Millard et al. 2013 eq. A6; reference h:644-654):

        k_fiber_AT * v_fiber_AT - k_tendon * (vMT - v_fiber_AT)

    The fiber stiffness along the tendon is the derivative of
    fiberForceAlongTendon w.r.t. fiber length along the tendon with the
    force-velocity multiplier held fixed; elementwise, so one
    ``torch.func.jvp`` with a unit tangent gives it for every muscle."""
    kT = tendon_kT(p["tendon_strain_at_one_norm_force"])
    (norm_tendon_length, fiber_length, norm_fiber_length, cos_pen,
     sin_pen) = compliant_tendon_state(p, norm_tendon_force, lMT)
    norm_tendon_velocity = tendon_force_length_inverse_derivative(
        d_norm_tendon_force, norm_tendon_length, kT)
    tendon_velocity = p["tendon_slack_length"] * norm_tendon_velocity
    fiber_vel_at = vMT - tendon_velocity
    fiber_velocity = fiber_vel_at * cos_pen
    norm_fiber_velocity = fiber_velocity / (
        p["max_contraction_velocity"] * p["optimal_fiber_length"])
    fv = force_velocity(norm_fiber_velocity)
    fmax = p["max_isometric_force"]

    def fiber_force_at(fiber_len_at):
        fl, nfl, cp_, sp_ = _fiber_geometry(p, fiber_len_at)
        fl_act = active_force_length(nfl, p["active_force_width_scale"])
        fl_pas = passive_force_length(
            nfl, p["passive_fiber_strain_at_one_norm_force"],
            ignore=ignore_passive_fiber_force)
        ff = fmax * (activation * fl_act * fv + fl_pas +
                     p["fiber_damping"] * norm_fiber_velocity)
        return ff * cp_

    tendon_length = p["tendon_slack_length"] * norm_tendon_length
    fiber_len_at = lMT - tendon_length
    _, k_fiber_at = torch.func.jvp(fiber_force_at, (fiber_len_at,),
                                   (torch.ones_like(fiber_len_at),))
    k_tendon = fmax * tendon_force_multiplier_derivative(
        norm_tendon_length, kT) / p["tendon_slack_length"]
    return k_fiber_at * fiber_vel_at - k_tendon * (vMT - fiber_vel_at)
