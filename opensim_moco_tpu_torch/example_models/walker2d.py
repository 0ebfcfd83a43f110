"""A planar walker with gait2d's topology and names, over half a gait
cycle: the model's data, its reference motion and ground reaction forces
(computed in numpy), and one builder for the model, each taking either
package's classes. Imports neither package (only numpy, scipy and the
leg's data in ``contact_leg``), so the JAX package's tests, the port's
tests and the port's ``examples.walker2d_track_study`` build the same
problem from it. It stands in for OpenSim's 2D walking example
(gait10dof18musc), whose model and data files are not in the repository.

The model (gravity (0, -9.81, 0); x forward, y up, rotations about z;
every point at z = 0):

- ``pelvis`` on the custom joint ``groundPelvis`` (``pelvis_tilt``,
  ``pelvis_tx``, ``pelvis_ty``), the contact leg's pelvis;
- for each side s in r and l, the contact leg's segments, masses,
  inertias and offsets: ``femur_s`` on the revolute ``hip_s``
  (``hip_flexion_s``), ``tibia_s`` on the spline-coupled custom ``knee_s``
  (``knee_angle_s``, the leg's knee splines) and ``calcn_s`` (the leg's
  foot) on the revolute ``ankle_s`` (``ankle_angle_s``), with the spheres
  ``contactHeel_s`` and ``contactFront_s`` at the leg's centres and radii
  and the stiffness of the 2D walking example's spheres (3,067,776; the
  other parameters the SmoothSphereHalfSpaceForce defaults), so that 6 mm
  of indentation of one flat foot carries about the body weight;
- ``torso`` (34.2366 kg, COM (-0.03, 0.32, 0), I = diag(1.4745, 0.7555,
  1.4314): gait10dof18musc's torso) on the revolute ``lumbar``
  (coordinate ``lumbar``), 0.1007 m behind and 0.0815 m above the pelvis
  origin.

Nine DeGrooteFregly2016 muscles a side, with activation dynamics and rigid
tendons, on fixed path points, at gait10dof18musc's maximum isometric
forces: ``hamstrings`` (hip extension, knee flexion), ``bifemsh``,
``glut_max``, ``iliopsoas``, ``rect_fem`` (hip flexion, knee extension),
``vasti``, ``gastroc`` (knee flexion, plantarflexion), ``soleus`` and
``tib_ant``; each with l_opt = 0.55 l0 and l_slack = 0.45 l0, l0 its path
length in the mean pose of the gait cycle. ``lumbarAct``, a coordinate
actuator on ``lumbar`` (optimal force 150, controls in [-1, 1]), holds the
torso. The pelvis has residuals as the contact leg has them
(``RESIDUALS``): coordinate actuators ``pelvis_tilt_actuator``,
``pelvis_tx_actuator`` and ``pelvis_ty_actuator`` (optimal force 100,
controls in [-10, 10]). In ``Track``'s effort goal (weight 10) each
costs 10 per squared control, as the leg's cost in its own. Without
them the stiff contact leaves the pelvis's height alone to carry the
dynamics, and the solver needs far more iterations (``PERF.md``). There
are no reserve actuators.

The reference: a gait cycle of period 2 T, T = ``HALF_CYCLE`` (the
final time of the JAX package's ``gait2d_tracking_study``), of which the
tracked window [0, T] is the first half; the tables run half a step past
each end of it (``SAMPLES``). The pelvis moves forward at ``SPEED``
with a constant tilt and bobs once a step; the lumbar angle puts the
torso's COM over its joint. Each foot's stance (the first
``TOE_OFF_PHASE`` of its stride) is planned in the world: the foot lands
toes up on its heel sphere and rolls about that sphere's centre to flat,
stays flat, then rolls about its front sphere's centre to toe-off; the
hip and knee angles follow by the leg's inverse kinematics and the ankle
from the foot's angle. The swing joins toe-off to the next heel strike
by a cubic in each joint angle, with extra knee flexion and
dorsiflexion for clearance. The left leg is the right leg half a cycle
later, left(t) = right(t + T), so the half-cycle symmetry rows hold on
the reference. ``pelvis_ty`` is set, as in the contact leg, so that the
lowest sphere of the lower foot is ``INDENTATION`` below the ground
(the stance foot; the swing foot stays above it). Every coordinate stays
inside the JAX package's ``_gait2d_state_bounds``. The sagittal ground
reaction force of each foot: its stance weight (1 in single stance, 0
in swing, a quintic step across double support) times the body weight
plus the total mass times the pelvis's vertical acceleration; the other
components are 0.
"""

import numpy as np
from scipy.interpolate import CubicSpline as _SciPySpline
from scipy.optimize import brentq

from . import contact_leg as _leg

GRAVITY = _leg.GRAVITY
HALF_CYCLE = 0.47008941
SPEED = 1.2
INDENTATION = _leg.INDENTATION
SIDES = ("r", "l")
TORSO = ("torso", 34.2366, (-0.03, 0.32, 0.0), (1.4745, 0.7555, 1.4314))
LUMBAR_IN_PELVIS = (-0.1007, 0.0815, 0.0)
TOTAL_MASS = _leg.SEGMENTS[0][1] + 2 * sum(s[1] for s in _leg.SEGMENTS[1:]) \
    + TORSO[1]
# SmoothSphereHalfSpaceForce parameters of the walker's spheres
CONTACT = {"stiffness": 3067776.0, "dissipation": 2.0}
# (name, F_max, path): a path point is (segment, location in its frame),
# segment 0 the pelvis, 1 the femur, 2 the tibia, 3 the foot of that side
MUSCLES = (
    ("hamstrings", 2594.0, ((0, (-0.12, -0.10, 0.0)),
                            (2, (-0.03, -0.05, 0.0)))),
    ("bifemsh", 804.0, ((1, (-0.01, -0.21, 0.0)),
                        (2, (-0.03, -0.05, 0.0)))),
    ("glut_max", 1944.0, ((0, (-0.15, -0.03, 0.0)),
                          (1, (-0.045, -0.08, 0.0)))),
    ("iliopsoas", 2342.0, ((0, (-0.02, 0.03, 0.0)),
                           (1, (0.03, -0.06, 0.0)))),
    ("rect_fem", 1169.0, ((0, (-0.03, -0.03, 0.0)),
                          (1, (0.045, -0.38, 0.0)),
                          (2, (0.04, -0.06, 0.0)))),
    ("vasti", 5000.0, ((1, (0.035, -0.22, 0.0)),
                       (1, (0.045, -0.38, 0.0)),
                       (2, (0.04, -0.06, 0.0)))),
    ("gastroc", 2500.0, ((1, (-0.02, -0.38, 0.0)),
                         (3, (-0.05, -0.02, 0.0)))),
    ("soleus", 5137.0, ((2, (-0.02, -0.15, 0.0)),
                        (3, (-0.05, -0.02, 0.0)))),
    ("tib_ant", 3000.0, ((2, (0.03, -0.16, 0.0)),
                         (2, (0.035, -0.40, 0.0)),
                         (3, (0.10, -0.01, 0.0)))),
)
LUMBAR_ACTUATOR = ("lumbarAct", 150.0, 1.0)  # name, optimal force, bound
RESIDUALS = _leg.RESIDUALS  # pelvis_tilt, pelvis_tx, pelvis_ty
COORDS = ("pelvis_tilt", "pelvis_tx", "pelvis_ty",
          "hip_flexion_r", "knee_angle_r", "ankle_angle_r",
          "hip_flexion_l", "knee_angle_l", "ankle_angle_l", "lumbar")
JOINT_OF = {"pelvis_tilt": "groundPelvis", "pelvis_tx": "groundPelvis",
            "pelvis_ty": "groundPelvis", "lumbar": "lumbar",
            **{f"{c}_{s}": f"{j}_{s}" for s in SIDES
               for c, j in (("hip_flexion", "hip"), ("knee_angle", "knee"),
                            ("ankle_angle", "ankle"))}}
# the reference's samples: T / 100 apart over [-T / 2, 3 T / 2], half a
# step past each end of the tracked window [0, T], so that the 6 Hz
# low-pass filter's start and end transients and the one-sided
# differences of the derived speeds fall outside it
SAMPLES = 201

# the gait: pelvis tilt and forward position at t = 0, its height
# TY_MEAN + sum_j a_j cos(2 pi j t / T - c_j), (a_j, c_j) the j-th of
# TY_HARMONICS (period T: one bob a step); a stride's phases (heel
# strike at 0, foot flat, heel off, toe-off, as fractions of 2 T); the
# foot's angle at heel strike and toe-off; where the right heel sphere's
# centre lands ahead of the pelvis origin at t = 0; the swing's extra knee
# flexion and dorsiflexion (peak, sin^2 profile)
TILT = np.deg2rad(-18.2)
TX0 = 0.2
TY_MEAN, TY_HARMONICS = 0.8977, ((-0.0244, 0.5505),)
FOOT_FLAT_PHASE, HEEL_OFF_PHASE, TOE_OFF_PHASE = 0.037, 0.186, 0.55
HEEL_STRIKE_ANGLE, TOE_OFF_ANGLE = np.deg2rad(16.1), np.deg2rad(39.7)
HEEL_AHEAD = 0.0566
SWING_KNEE, SWING_ANKLE = np.deg2rad(45.0), np.deg2rad(23.1)
# the lumbar angle that puts the torso's COM over the lumbar joint
LUMBAR = -np.arctan2(-TORSO[2][0], TORSO[2][1]) - TILT

_HEEL, _FRONT = ((np.asarray(c[:2]), r) for _, c, r in _leg.SPHERES)


def coordinate_path(coord):
    return f"/jointset/{JOINT_OF[coord]}/{coord}"


def _smoothstep(x):
    x = np.clip(x, 0.0, 1.0)
    return x ** 3 * (10.0 - 15.0 * x + 6.0 * x * x)


def pelvis_height(t, derivative=0):
    """The pelvis's height (or its first or second time derivative) at
    times t."""
    t = np.asarray(t, dtype=np.float64)
    out = np.full_like(t, TY_MEAN if derivative == 0 else 0.0)
    for j, (a, c) in enumerate(TY_HARMONICS, 1):
        w = 2.0 * np.pi * j / HALF_CYCLE
        # d^n/dt^n cos(w t - c) = w^n cos(w t - c + n pi / 2)
        out = out + a * w ** derivative * np.cos(
            w * t - c + derivative * np.pi / 2)
    return out


def _knee_splines():
    return _leg._knee_splines(
        lambda x, y: _SciPySpline(x, y, bc_type="natural"))


def _hip(t):
    """The hip joint centre in the world at time t (both sides)."""
    return (np.array([TX0 + SPEED * t, pelvis_height(t)])
            + _leg._rot(TILT) @ np.asarray(_leg.HIP_IN_PELVIS[:2]))


def _stance(phi):
    """(hip, knee, ankle) of the right leg at stride phase phi in stance,
    by inverse kinematics from the planned foot."""
    kx, ky = _knee_splines()
    ankle_in_tibia = np.asarray(_leg.ANKLE_IN_TIBIA[:2])
    heel = np.array([TX0 + HEEL_AHEAD, _HEEL[1] - INDENTATION])
    front = heel + _FRONT[0] - _HEEL[0]
    if phi < FOOT_FLAT_PHASE:
        th = HEEL_STRIKE_ANGLE * (1.0 - _smoothstep(phi / FOOT_FLAT_PHASE))
        ankle = heel - _leg._rot(th) @ _HEEL[0]
    elif phi < HEEL_OFF_PHASE:
        th = 0.0
        ankle = heel - _HEEL[0]
    else:
        th = -TOE_OFF_ANGLE * _smoothstep(
            (phi - HEEL_OFF_PHASE) / (TOE_OFF_PHASE - HEEL_OFF_PHASE))
        ankle = front - _leg._rot(th) @ _FRONT[0]
    d = ankle - _hip(2.0 * HALF_CYCLE * phi)

    def reach(k):
        return np.array([kx(k), ky(k)]) + _leg._rot(k) @ ankle_in_tibia

    knee = brentq(lambda k: np.linalg.norm(reach(k)) - np.linalg.norm(d),
                  -1.5, -0.03, xtol=1e-15)
    r = reach(knee)
    thigh = np.arctan2(d[1], d[0]) - np.arctan2(r[1], r[0])
    return np.array([thigh - TILT, knee, th - thigh - knee])


def right_leg(phi):
    """(hip_flexion, knee_angle, ankle_angle) of the right leg at stride
    phase phi (heel strike at 0; periodic with period 1)."""
    phi = phi % 1.0
    if phi <= TOE_OFF_PHASE:
        return _stance(phi)
    # the swing: a cubic Hermite per angle from toe-off to the next heel
    # strike (slopes by finite differences within stance), plus bumps
    e = 1e-6
    q0, q1 = _stance(TOE_OFF_PHASE), _stance(0.0)
    span = 1.0 - TOE_OFF_PHASE
    v0 = (q0 - _stance(TOE_OFF_PHASE - e)) / e * span
    v1 = (_stance(e) - q1) / e * span
    u = (phi - TOE_OFF_PHASE) / span
    q = ((2 * u ** 3 - 3 * u ** 2 + 1) * q0 + (u ** 3 - 2 * u ** 2 + u) * v0
         + (3 * u ** 2 - 2 * u ** 3) * q1 + (u ** 3 - u ** 2) * v1)
    return q + np.array([0.0, -SWING_KNEE, SWING_ANKLE]) * \
        np.sin(np.pi * u) ** 2


def _leg_frames(tilt, tx, ty, hip, knee, ankle):
    """World (origin (2,), angle) of the pelvis, femur, tibia and foot of
    one leg."""
    kx, ky = _knee_splines()
    o0, a0 = np.array([tx, ty]), tilt
    o1 = o0 + _leg._rot(a0) @ np.asarray(_leg.HIP_IN_PELVIS[:2])
    a1 = a0 + hip
    o2 = o1 + _leg._rot(a1) @ np.array([kx(knee), ky(knee)])
    a2 = a1 + knee
    o3 = o2 + _leg._rot(a2) @ np.asarray(_leg.ANKLE_IN_TIBIA[:2])
    return [(o0, a0), (o1, a1), (o2, a2), (o3, a2 + ankle)]


def lowest_points(q):
    """The lowest sphere point's height of the right and the left foot at
    one pose q (10,) in COORDS order."""
    out = []
    for s in range(2):
        o, a = _leg_frames(*q[:3], *q[3 + 3 * s:6 + 3 * s])[3]
        out.append(min((o + _leg._rot(a) @ c)[1] - r
                       for c, r in (_HEEL, _FRONT)))
    return np.array(out)


def pose(t):
    """The reference pose (10,) in COORDS order at time t."""
    phi = t / (2.0 * HALF_CYCLE)
    q = np.concatenate([[TILT, TX0 + SPEED * t, 0.0], right_leg(phi),
                        right_leg(phi + 0.5), [LUMBAR]])
    q[2] = -INDENTATION - lowest_points(q).min()
    return q


def reference_times():
    """The reference's SAMPLES times, over [-T / 2, 3 T / 2]; 0 and T are
    among them exactly."""
    steps = (SAMPLES - 1) // 2
    return HALF_CYCLE * (np.arange(SAMPLES) - steps / 2) / steps


def reference():
    """(times (SAMPLES,), coordinate values (SAMPLES, 10) in COORDS
    order)."""
    t = reference_times()
    return t, np.stack([pose(tk) for tk in t])


def stance_weight(t, side):
    """The share of the vertical ground reaction force that foot ``side``
    ("r" or "l") carries at times t: 1 in single stance, 0 in swing, a
    quintic step across each double support; the two sum to 1."""
    phi = (np.asarray(t) / (2.0 * HALF_CYCLE) + (0.5 if side == "l"
                                                   else 0.0)) % 1.0
    ds = TOE_OFF_PHASE - 0.5
    return np.where(phi < 0.5, _smoothstep(phi / ds),
                    1.0 - _smoothstep((phi - 0.5) / ds))


def grf_reference():
    """``{"Right_GRF"|"Left_GRF": (times (SAMPLES,), forces (SAMPLES, 3))}``
    over the reference's times, in the form of the JAX package's
    ``_gait2d_grf_reference``."""
    t = reference_times()
    total = TOTAL_MASS * (-GRAVITY[1] + pelvis_height(t, 2))
    out = {}
    for side, key in (("r", "Right_GRF"), ("l", "Left_GRF")):
        f = np.zeros((len(t), 3))
        f[:, 1] = stance_weight(t, side) * total
        out[key] = (t, f)
    return out


def mean_pose():
    """The pose at the right leg's mean joint angles over a stride, on
    both sides (the left leg's mean is the same)."""
    mean = np.mean([right_leg(p) for p in np.linspace(0, 1, 200,
                                                      endpoint=False)], 0)
    return np.concatenate([[TILT, TX0, TY_MEAN], mean, mean, [LUMBAR]])


def path_lengths(q):
    """The right side's muscle path lengths (9,) at one pose q (10,)."""
    fr = _leg_frames(*q[:6])
    return np.array([sum(
        np.linalg.norm(_leg._world(fr, *b) - _leg._world(fr, *a))
        for a, b in zip(path[:-1], path[1:])) for _, _, path in MUSCLES])


def build_walker(MechModelBuilder, Model, CubicSpline, muscle):
    """The walker as a ``Model`` of the package whose ``MechModelBuilder``,
    ``Model``, ``CubicSpline`` and muscle module (``default_muscle_params``)
    are given; finalized."""
    kx, ky = _leg._knee_splines(CubicSpline)
    ident = _leg.Identity()

    def axes(rot, tx, ty):
        return (((0, 0, 1), rot, 0), ((1, 0, 0), None, 0),
                ((0, 1, 0), None, 0), ((1, 0, 0), tx[0], tx[1]),
                ((0, 1, 0), ty[0], ty[1]), ((0, 0, 1), None, 0))

    (pn, pm, pc, pi), (_, fm, fc, fi), (_, tm, tc, ti), \
        (_, cm, cc, ci) = _leg.SEGMENTS
    b = MechModelBuilder(gravity=GRAVITY)
    b.add_body(pn, mass=pm, com=pc, inertia=np.diag(pi), kind="custom",
               joint_name="groundPelvis", coord_names=COORDS[:3],
               custom_axes=axes(ident, (ident, 1), (ident, 2)))
    for s in SIDES:
        b.add_body(f"femur_{s}", mass=fm, com=fc, inertia=np.diag(fi),
                   parent=pn, joint_name=f"hip_{s}", kind="revolute",
                   axis=(0, 0, 1), tree_r=_leg.HIP_IN_PELVIS,
                   coord_name=f"hip_flexion_{s}")
        b.add_body(f"tibia_{s}", mass=tm, com=tc, inertia=np.diag(ti),
                   parent=f"femur_{s}", kind="custom",
                   joint_name=f"knee_{s}", coord_names=(f"knee_angle_{s}",),
                   custom_axes=axes(ident, (kx, 0), (ky, 0)))
        b.add_body(f"calcn_{s}", mass=cm, com=cc, inertia=np.diag(ci),
                   parent=f"tibia_{s}", joint_name=f"ankle_{s}",
                   kind="revolute", axis=(0, 0, 1),
                   tree_r=_leg.ANKLE_IN_TIBIA,
                   coord_name=f"ankle_angle_{s}")
    tn, tmass, tcom, tinert = TORSO
    b.add_body(tn, mass=tmass, com=tcom, inertia=np.diag(tinert), parent=pn,
               joint_name="lumbar", kind="revolute", axis=(0, 0, 1),
               tree_r=LUMBAR_IN_PELVIS, coord_name="lumbar")
    model = Model(b.finalize())
    l0 = path_lengths(mean_pose())
    for si, s in enumerate(SIDES):
        bodies = (0, 1 + 3 * si, 2 + 3 * si, 3 + 3 * si)
        for name, centre, radius in _leg.SPHERES:
            model.add_sphere_contact(name[:-2] + f"_{s}", bodies[3], centre,
                                     radius, **CONTACT)
        for (name, f_max, path), length in zip(MUSCLES, l0):
            params = muscle.default_muscle_params(
                max_isometric_force=f_max,
                optimal_fiber_length=0.55 * length,
                tendon_slack_length=0.45 * length)
            model.add_muscle(f"{name}_{s}",
                             path=[(bodies[seg], loc) for seg, loc in path],
                             params=params, ignore_activation_dynamics=False,
                             ignore_tendon_compliance=True)
    for coord in RESIDUALS:
        model.add_coordinate_actuator(
            f"{coord}_actuator", coord, optimal_force=_leg.ACTUATOR_FORCE,
            min_control=-_leg.ACTUATOR_BOUND, max_control=_leg.ACTUATOR_BOUND)
    name, force, bound = LUMBAR_ACTUATOR
    model.add_coordinate_actuator(name, "lumbar", optimal_force=force,
                                  min_control=-bound, max_control=bound)
    return model.finalize()
