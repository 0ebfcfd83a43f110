"""A planar one-legged stance on two contact spheres, squatting once: the
model's data, its reference motion and ground reaction force (computed in
numpy), and one builder for the model and one for the tracking problem,
each taking either package's classes. Imports neither package, so the
JAX package's tests, the port's tests, the port's
``examples.contact_leg_study`` and ``chip_smoke.py`` build the same
problem from it.

The model (gravity (0, -9.81, 0); x forward, y up, rotations about z):

- ``pelvis`` (11.777 kg, COM (-0.0707, 0, 0), I = diag(0.1028, 0.0871,
  0.0579)) on a custom joint to ground, ``groundPelvis``, with the
  coordinates ``pelvis_tilt`` (rotation about z), ``pelvis_tx`` and
  ``pelvis_ty`` (translations);
- ``femur`` (9.3014 kg, COM (0, -0.17, 0), I = diag(0.1339, 0.0351,
  0.1412)) on a revolute hip ``hip_flexion``, 0.0707 m behind and 0.0661
  m below the pelvis origin;
- ``tibia`` (3.7075 kg, COM (0, -0.1867, 0), I = diag(0.0504, 0.0051,
  0.0511)) on a one-coordinate custom knee ``knee_angle`` (flexion
  negative): its rotation is the identity of ``knee_angle`` and its x and
  y translations are natural cubic splines of ``knee_angle`` through the
  knee data of the Delp lower-limb model (the femur's length, about 0.40
  m, is the y translation);
- ``foot`` (1.25 kg, COM (0.05, -0.01, 0), I = diag(0.0014, 0.0039,
  0.0041)) on a revolute ankle ``ankle_angle``, 0.43 m down the tibia,
  with two smooth spheres at the SmoothSphereHalfSpaceForce defaults:
  ``contactHeel_r`` (radius 0.035 m, centre (-0.0175, -0.0315, 0)) and
  ``contactFront_r`` (radius 0.015 m, centre (0.1286, -0.0515, 0)), their
  lowest points level when the foot is flat.

These are the masses, inertias and joint offsets of the gait2d model's
right leg (gait10dof18musc). Four DeGrooteFregly2016 muscles with
activation dynamics and rigid tendons run between fixed path points: a
hip flexor (iliopsoas, F_max 2342 N), a hip extensor (gluteus maximus,
1944 N), a knee extensor (vasti, 5000 N) and an ankle plantarflexor
(soleus, 5137 N), each with l_opt = 0.55 l0 and l_slack = 0.45 l0, l0
its path length in the mean pose of the squat. Coordinate actuators on
all six coordinates (optimal force 100, controls in [-10, 10]) are the
pelvis residuals and the joint reserves.

Six markers sit on the bodies (``MARKERS``: one on the pelvis, two on the
femur, one on the tibia, the heel and the toe on the foot);
``build_leg`` sets them on ``model.markers``. ``marker_trc_text`` writes
their positions along the reference as a .trc in mm, with the tibia's
marker blank in a few frames in the middle and one more marker on no
body.

The reference: one squat in 1 s. The hip and knee follow cosines,
hip = 0.05 + 0.4 (1 - cos 2 pi t) / 2 and knee = -0.1 - 0.8 (1 - cos
2 pi t) / 2; the pelvis keeps tilt 0 and the ankle keeps the foot flat
(ankle = -(tilt + hip + knee)). ``pelvis_tx`` holds the ankle over x =
0 and ``pelvis_ty`` the spheres' lowest points at 6 mm below the ground,
both from the planar forward kinematics with the knee's splines. The
vertical ground reaction force is the body weight plus the total mass
times the pelvis's vertical acceleration; the other two components are
0.
"""

import numpy as np
from scipy.interpolate import CubicSpline as _SciPySpline

GRAVITY = (0.0, -9.81, 0.0)
DURATION = 1.0
INDENTATION = 0.006
# (name, mass, com, diag inertia)
SEGMENTS = (
    ("pelvis", 11.777, (-0.0707, 0.0, 0.0), (0.1028, 0.0871, 0.0579)),
    ("femur", 9.3014, (0.0, -0.17, 0.0), (0.1339, 0.0351, 0.1412)),
    ("tibia", 3.7075, (0.0, -0.1867, 0.0), (0.0504, 0.0051, 0.0511)),
    ("foot", 1.25, (0.05, -0.01, 0.0), (0.0014, 0.0039, 0.0041)),
)
TOTAL_MASS = sum(s[1] for s in SEGMENTS)
HIP_IN_PELVIS = (-0.0707, -0.0661, 0.0)
ANKLE_IN_TIBIA = (0.0, -0.43, 0.0)
# knee translations against knee_angle (Delp lower-limb model)
KNEE_X = ((-2.0944, -1.74533, -1.39626, -1.0472, -0.698132, -0.349066,
           -0.174533, 0.197344, 0.337395, 0.490178, 1.52146, 2.0944),
          (-0.0032, 0.00179, 0.00411, 0.0041, 0.00212, -0.001, -0.0031,
           -0.005227, -0.005435, -0.005574, -0.005435, -0.00525))
KNEE_Y = ((-2.0944, -1.22173, -0.523599, -0.349066, -0.174533, 0.159149,
           2.0944),
          (-0.4226, -0.4082, -0.399, -0.3976, -0.3966, -0.395264, -0.396))
# (name, centre in the foot frame, radius)
SPHERES = (("contactHeel_r", (-0.0175, -0.0315, 0.0), 0.035),
           ("contactFront_r", (0.1286, -0.0515, 0.0), 0.015))
# (name, F_max, path): body -1 is ground, 0 the pelvis, 1 the femur, 2 the
# tibia, 3 the foot; local coordinates in metres
MUSCLES = (
    ("iliopsoas_r", 2342.0, ((0, (-0.02, 0.03, 0.0)),
                             (1, (0.03, -0.06, 0.0)))),
    ("glut_max_r", 1944.0, ((0, (-0.14, 0.0, 0.0)),
                            (1, (-0.03, -0.08, 0.0)))),
    ("vasti_r", 5000.0, ((1, (0.035, -0.22, 0.0)),
                         (2, (0.05, -0.05, 0.0)))),
    ("soleus_r", 5137.0, ((2, (-0.02, -0.15, 0.0)),
                          (3, (-0.05, -0.02, 0.0)))),
)
COORDS = ("pelvis_tilt", "pelvis_tx", "pelvis_ty", "hip_flexion",
          "knee_angle", "ankle_angle")
JOINT_OF = {"pelvis_tilt": "groundPelvis", "pelvis_tx": "groundPelvis",
            "pelvis_ty": "groundPelvis", "hip_flexion": "hip",
            "knee_angle": "knee", "ankle_angle": "ankle"}
ACTUATOR_FORCE = 100.0
ACTUATOR_BOUND = 10.0
RESIDUALS = ("pelvis_tilt", "pelvis_tx", "pelvis_ty")
# goal weights: tracking as gait2d's MocoTrack (10), the residuals
# weighted heavily in the effort; the GRF tracking at 0.001, not gait2d's
# 1: the sphere force changes by about 3e4 N per metre of indentation, so
# at 1 the GRF term's curvature outweighs the rest of the objective a
# millionfold, and from the jittered bounds-midpoint starts (feet 2 cm
# above or below the ground) the solver stalls (at 0.1 too; at 0.01 three
# of eight lanes were still far off after 41 iterations, at 0.001 seven
# had converged after 43, on the CPU)
TRACKING_WEIGHT = 10.0
EFFORT_WEIGHT = 0.1
RESIDUAL_WEIGHT = 100.0
GRF_WEIGHT = 0.001
SAMPLES = 101
# (name, body, location in the body frame); z offsets put the markers off
# the sagittal plane, where rotations about z leave them
MARKERS = (("PELV", 0, (-0.05, 0.04, 0.06)),
           ("THIGH", 1, (0.03, -0.18, 0.07)),
           ("KNEE", 1, (0.02, -0.38, 0.05)),
           ("SHANK", 2, (0.03, -0.2, 0.04)),
           ("HEEL", 3, (-0.04, -0.03, 0.0)),
           ("TOE", 3, (0.16, -0.045, 0.01)))
# a marker of the .trc on no body of the model, at a fixed point
UNUSED_MARKER = ("FORCEPLATE", (0.3, 0.0, 0.2))
# frames where SHANK is blank in the .trc
BLANK_FRAMES = range(45, 50)


class Identity:
    """f(v) = v as a custom joint's axis function, with the derivatives
    that the port's custom joints take from an axis function when it has
    them (the JAX package differentiates the call)."""

    def __call__(self, v):
        return v

    def derivative(self, v):
        return 1.0

    def second_derivative(self, v):
        return 0.0


def _knee_splines(Spline):
    return Spline(*map(np.asarray, KNEE_X)), Spline(*map(np.asarray, KNEE_Y))


def _rot(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s], [s, c]])


def _planar_frames(q):
    """World (origin (2,), angle) of pelvis, femur, tibia and foot at one
    pose q (6,) in COORDS order."""
    kx, ky = _knee_splines(lambda x, y: _SciPySpline(x, y,
                                                     bc_type="natural"))
    tilt, tx, ty, hip, knee, ankle = q
    o0, a0 = np.array([tx, ty]), tilt
    o1 = o0 + _rot(a0) @ np.asarray(HIP_IN_PELVIS[:2])
    a1 = a0 + hip
    o2 = o1 + _rot(a1) @ np.array([kx(knee), ky(knee)])
    a2 = a1 + knee
    o3 = o2 + _rot(a2) @ np.asarray(ANKLE_IN_TIBIA[:2])
    a3 = a2 + ankle
    return [(o0, a0), (o1, a1), (o2, a2), (o3, a3)]


def _world(frames, body, loc):
    if body < 0:
        return np.asarray(loc[:2], dtype=np.float64)
    o, a = frames[body]
    return o + _rot(a) @ np.asarray(loc[:2])


def _joint_angles(t):
    s = 0.5 * (1.0 - np.cos(2 * np.pi * t / DURATION))
    hip = 0.05 + 0.4 * s
    knee = -0.1 - 0.8 * s
    return hip, knee, -(hip + knee)


def _pose(hip, knee, ankle):
    """The pose with tilt 0, the ankle over x = 0 and the spheres' lowest
    points INDENTATION below the ground."""
    fr = _planar_frames(np.array([0.0, 0.0, 0.0, hip, knee, ankle]))
    ankle_xy = fr[3][0]
    low = min(_world(fr, 3, c)[1] - r for _, c, r in SPHERES)
    return np.array([0.0, -ankle_xy[0], -INDENTATION - low, hip, knee, ankle])


def reference():
    """(times (K,), coordinate values (K, 6) in COORDS order,
    GRF (K, 3))."""
    t = np.linspace(0.0, DURATION, SAMPLES)
    q = np.stack([_pose(*a) for a in zip(*_joint_angles(t))])
    ty = _SciPySpline(t, q[:, 2], bc_type="periodic")
    grf = np.zeros((len(t), 3))
    grf[:, 1] = TOTAL_MASS * (-GRAVITY[1] + ty(t, 2))
    return t, q, grf


def mean_pose():
    """The pose at the mean joint angles of the squat (the centre of the
    coordinate bounds)."""
    t = np.linspace(0.0, DURATION, SAMPLES)
    return _pose(*(np.mean(a) for a in _joint_angles(t)))


def marker_positions(q):
    """World positions (K, len(MARKERS), 3) of the markers at poses q
    (K, 6), from the planar kinematics above."""
    out = np.zeros((len(q), len(MARKERS), 3))
    for k, qk in enumerate(q):
        fr = _planar_frames(qk)
        for i, (_, body, loc) in enumerate(MARKERS):
            out[k, i, :2] = _world(fr, body, loc)
            out[k, i, 2] = loc[2]
    return out


def marker_trc_text():
    """The markers along the reference as .trc text, in mm, at the
    SAMPLES reference times: MARKERS, SHANK blank in BLANK_FRAMES, and
    UNUSED_MARKER last."""
    t, q, _ = reference()
    pos = marker_positions(q) * 1e3
    names = [m[0] for m in MARKERS] + [UNUSED_MARKER[0]]
    lines = ["PathFileType\t4\t(X/Y/Z)\tcontact_leg.trc",
             "DataRate\tCameraRate\tNumFrames\tNumMarkers\tUnits\t"
             "OrigDataRate\tOrigDataStartFrame\tOrigNumFrames",
             f"{SAMPLES - 1:g}\t{SAMPLES - 1:g}\t{SAMPLES}\t{len(names)}\t"
             f"mm\t{SAMPLES - 1:g}\t1\t{SAMPLES}",
             "Frame#\tTime\t" + "\t\t\t".join(names),
             "\t\t" + "\t".join(f"{c}{i + 1}" for i in range(len(names))
                                 for c in "XYZ")]
    shank = [m[0] for m in MARKERS].index("SHANK")
    fixed = [f"{1e3 * v:.17g}" for v in UNUSED_MARKER[1]]
    for k in range(SAMPLES):
        cells = []
        for i in range(len(MARKERS)):
            cells += ([""] * 3 if i == shank and k in BLANK_FRAMES
                      else [f"{v:.17g}" for v in pos[k, i]])
        lines.append("\t".join([str(k + 1), f"{t[k]:.17g}"] + cells
                                + fixed))
    return "\n".join(lines) + "\n"


def path_lengths(q):
    """Muscle path lengths at one pose q (6,)."""
    fr = _planar_frames(q)
    return np.array([sum(np.linalg.norm(_world(fr, *b) - _world(fr, *a))
                         for a, b in zip(path[:-1], path[1:]))
                     for _, _, path in MUSCLES])


def build_leg(MechModelBuilder, Model, CubicSpline, muscle):
    """The leg as a ``Model`` of the package whose ``MechModelBuilder``,
    ``Model``, ``CubicSpline`` and muscle module (``default_muscle_params``)
    are given; finalized."""
    kx, ky = _knee_splines(CubicSpline)
    ident = Identity()

    def axes(rot, tx, ty):
        return (((0, 0, 1), rot, 0), ((1, 0, 0), None, 0),
                ((0, 1, 0), None, 0), ((1, 0, 0), tx[0], tx[1]),
                ((0, 1, 0), ty[0], ty[1]), ((0, 0, 1), None, 0))

    (pn, pm, pc, pi), (fn, fm, fc, fi), (tn, tm, tc, ti), \
        (cn, cm, cc, ci) = SEGMENTS
    b = MechModelBuilder(gravity=GRAVITY)
    b.add_body(pn, mass=pm, com=pc, inertia=np.diag(pi), kind="custom",
               joint_name="groundPelvis", coord_names=COORDS[:3],
               custom_axes=axes(ident, (ident, 1), (ident, 2)))
    b.add_body(fn, mass=fm, com=fc, inertia=np.diag(fi), parent=pn,
               joint_name="hip", kind="revolute", axis=(0, 0, 1),
               tree_r=HIP_IN_PELVIS, coord_name="hip_flexion")
    b.add_body(tn, mass=tm, com=tc, inertia=np.diag(ti), parent=fn,
               kind="custom", joint_name="knee", coord_names=("knee_angle",),
               custom_axes=axes(ident, (kx, 0), (ky, 0)))
    b.add_body(cn, mass=cm, com=cc, inertia=np.diag(ci), parent=tn,
               joint_name="ankle", kind="revolute", axis=(0, 0, 1),
               tree_r=ANKLE_IN_TIBIA, coord_name="ankle_angle")
    model = Model(b.finalize())
    for name, centre, radius in SPHERES:
        model.add_sphere_contact(name, 3, centre, radius)
    for (name, f_max, path), l0 in zip(MUSCLES, path_lengths(mean_pose())):
        params = muscle.default_muscle_params(
            max_isometric_force=f_max, optimal_fiber_length=0.55 * l0,
            tendon_slack_length=0.45 * l0)
        model.add_muscle(name, path=list(path), params=params,
                         ignore_activation_dynamics=False,
                         ignore_tendon_compliance=True)
    for coord in COORDS:
        model.add_coordinate_actuator(
            f"{coord}_actuator", coord, optimal_force=ACTUATOR_FORCE,
            min_control=-ACTUATOR_BOUND, max_control=ACTUATOR_BOUND)
    model.markers.update({name: (body, loc) for name, body, loc in MARKERS})
    return model.finalize()


def coordinate_path(coord):
    return f"/jointset/{JOINT_OF[coord]}/{coord}"


# half-widths of the coordinate bounds around the mean pose, and the
# speed bounds, in COORDS order (the reference's speeds reach 0.26 m/s and
# 2.5 rad/s)
BOUND_HALF_WIDTHS = (0.3, 0.2, 0.15, 0.6, 0.7, 0.6)
SPEED_BOUNDS = (2.0, 1.0, 1.0, 5.0, 5.0, 5.0)


def build_study(ocp, model, num_mesh_intervals=50):
    """The squat's tracking problem as a ``Study`` of the package whose
    ``ocp`` module (``Problem``, ``Study`` and the goals) is given, for a
    ``model`` from :func:`build_leg`: Hermite-Simpson at
    ``num_mesh_intervals``; a ``StateTrackingGoal`` on the six coordinate
    values, then :func:`add_goals_and_bounds`."""
    t, q, _ = reference()
    pr = ocp.Problem(model)
    pr.set_time_bounds(0.0, DURATION)
    pr.add_goal(ocp.StateTrackingGoal(
        name="state_tracking", weight=TRACKING_WEIGHT,
        reference={f"{coordinate_path(c)}/value": (t, q[:, k])
                   for k, c in enumerate(COORDS)}))
    add_goals_and_bounds(ocp, pr, model)
    study = ocp.Study(pr)
    study.set_solver_options(num_mesh_intervals=num_mesh_intervals)
    return study


def add_goals_and_bounds(ocp, pr, model):
    """Add to ``pr`` the goals of the squat but its state tracking: a
    ``ControlGoal`` with the residuals weighted heavily, a
    ``PeriodicityGoal`` (endpoint constraints) on every state but
    ``pelvis_tx/value`` and a ``ContactTrackingGoal`` with one group (heel
    and front) projected on the sagittal plane; and the coordinate bounds,
    centred on the squat's mean pose, and the speed bounds."""
    t, _, grf = reference()
    centre = mean_pose()
    for k, coord in enumerate(COORDS):
        h = BOUND_HALF_WIDTHS[k]
        pr.set_state_info(f"{coordinate_path(coord)}/value",
                          (centre[k] - h, centre[k] + h))
        pr.set_state_info(f"{coordinate_path(coord)}/speed",
                          (-SPEED_BOUNDS[k], SPEED_BOUNDS[k]))
    pr.add_goal(ocp.ControlGoal(
        name="effort", weight=EFFORT_WEIGHT,
        control_weights={f"/forceset/{c}_actuator": RESIDUAL_WEIGHT
                         for c in RESIDUALS}))
    states = model.state_names()
    pr.add_goal(ocp.PeriodicityGoal(
        name="periodicity",
        state_pairs=tuple((s, s, False) for s in states
                          if s != f"{coordinate_path('pelvis_tx')}/value")))
    pr.add_goal(ocp.ContactTrackingGoal(
        name="grf_tracking", weight=GRF_WEIGHT,
        groups=((tuple(name for name, _, _ in SPHERES), "grf"),),
        reference={"grf": (t, grf)}, projection="plane",
        projection_vector=(0.0, 0.0, 1.0)))
