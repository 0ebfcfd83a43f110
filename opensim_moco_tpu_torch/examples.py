"""Example problems on the port's main path.

Counterparts of ``opensim_moco_tpu.examples`` builders, with the same
signatures and the same problems, plus two problems of the JAX package's
tests (the coupler-constrained double pendulum of ``test_constraints.py``
and the oscillator mass of ``test_parameters.py``) and the planar contact
leg of ``example_models/contact_leg.py``, directly and through the
``Track`` tool, and the planar walker of ``example_models/walker2d.py``
through ``Track`` with gait2d's symmetry rows and bounds, and in gait2d's
de-novo prediction; each returns a ready-to-solve
:class:`~opensim_moco_tpu_torch.ocp.study.Study`, but
``hanging_muscle_inverse``, which returns an ``Inverse`` tool, and
``contact_leg_track_study``, ``walker2d_track_study`` and
``walker2d_prediction_study``, which return the study and its guess.
"""

from __future__ import annotations

import numpy as np

from .models import MechModelBuilder
from .models import muscle as dgf
from .models.model import Model
import torch

from .ocp import (ControlGoal, CustomGoal, FinalTimeGoal,
                  InitialActivationGoal,
                  InitialForceEquilibriumGoal,
                  InitialVelocityEquilibriumDGFGoal, Problem, Study)


def sliding_mass_study(num_mesh_intervals=50, scheme="trapezoidal"):
    """exampleSlidingMass: point mass on a slider, move 0 -> 1 m in
    minimum time, final time free in [0, 5]."""
    b = MechModelBuilder(gravity=(0.0, 0.0, 0.0))
    b.add_body("body", mass=2.0, joint_name="slider", kind="prismatic",
               axis=(1, 0, 0), coord_name="position")
    model = Model(b.finalize())
    model.add_coordinate_actuator("actuator", "position", optimal_force=1.0)
    model.finalize()

    prob = Problem(model)
    prob.set_time_bounds(0, (0, 5))
    prob.set_state_info("/jointset/slider/position/value", (-5, 5), 0, 1)
    prob.set_state_info("/jointset/slider/position/speed", (-50, 50), 0, 0)
    prob.set_control_info("/forceset/actuator", (-50, 50))
    prob.add_goal(FinalTimeGoal(name="time"))

    study = Study(prob)
    study.set_solver_options(transcription_scheme=scheme,
                             num_mesh_intervals=num_mesh_intervals)
    return study


def _hanging_muscle_model(ignore_activation_dynamics,
                          ignore_tendon_compliance, tendon_dynamics_implicit):
    """The hanging muscle's body and muscle (reference testMocoActuators.cpp
    createHangingMuscleModel), not finalized."""
    b = MechModelBuilder(gravity=(9.81, 0.0, 0.0))
    b.add_body("body", mass=0.5, joint_name="joint", kind="prismatic",
               axis=(1, 0, 0), coord_name="height")
    model = Model(b.finalize())
    params = dgf.default_muscle_params(
        max_isometric_force=30.0, optimal_fiber_length=0.10,
        tendon_slack_length=0.05, pennation_angle_at_optimal=0.1,
        fiber_damping=0.01, tendon_strain_at_one_norm_force=0.10,
        max_contraction_velocity=10.0)
    model.add_muscle("muscle",
                     path=[(-1, (0.0, 0.0, 0.0)), (0, (0.0, 0.0, 0.0))],
                     params=params,
                     ignore_activation_dynamics=ignore_activation_dynamics,
                     ignore_tendon_compliance=ignore_tendon_compliance,
                     tendon_dynamics_implicit=tendon_dynamics_implicit)
    return model


def hanging_muscle_inverse(mesh_interval=0.02):
    """The hanging muscle as an inverse problem: its body and muscle, with
    activation dynamics and an implicit compliant tendon, plus a reserve
    on the height (optimal force 1, controls in [-10, 10]), prescribed to
    q = 0.145 + 0.005 cos 2 pi t on 101 points over [0, 1] s;
    ``Inverse(mesh_interval, reserves_weight=10)`` (the tool's tolerance
    and options). Returns the :class:`~opensim_moco_tpu_torch.tools.Inverse`."""
    from .tools import Inverse

    model = _hanging_muscle_model(False, False, True)
    model.add_coordinate_actuator("reserve", "height", optimal_force=1.0,
                                  min_control=-10, max_control=10)
    times = np.linspace(0.0, 1.0, 101)
    q = 0.145 + 0.005 * np.cos(2 * np.pi * times)
    return Inverse(model=model, kinematics=(times, q[:, None]),
                   mesh_interval=mesh_interval, reserves_weight=10.0)


def hanging_muscle_study(num_mesh_intervals=25,
                         ignore_activation_dynamics=False,
                         ignore_tendon_compliance=True,
                         tendon_dynamics_implicit=False,
                         scheme="hermite-simpson",
                         multibody_dynamics_mode="implicit"):
    """Hanging-muscle minimum time (reference testMocoActuators.cpp
    createHangingMuscleModel): a DeGrooteFregly2016 muscle between the
    ground origin and a 0.5 kg body on a slider aligned with gravity;
    raise the mass from height 0.15 to 0.14 in minimum time."""
    model = _hanging_muscle_model(ignore_activation_dynamics,
                                  ignore_tendon_compliance,
                                  tendon_dynamics_implicit)
    model.finalize()

    prob = Problem(model)
    prob.set_time_bounds(0, (0.05, 1.0))
    prob.set_state_info("/jointset/joint/height/value", (0.14, 0.16), 0.15,
                        0.14)
    prob.set_state_info("/jointset/joint/height/speed", (-1, 1), 0, 0)
    if not ignore_activation_dynamics:
        prob.add_goal(InitialActivationGoal(name="initial_activation",
                                            weight=1.0))
    if not ignore_tendon_compliance:
        # implicit tendon dynamics pairs with the velocity-equilibrium goal
        # in cost mode (w=0.001); explicit with the force-equilibrium goal
        if tendon_dynamics_implicit:
            prob.add_goal(InitialVelocityEquilibriumDGFGoal(
                name="initial_velocity_equilibrium", mode="cost",
                weight=0.001))
        else:
            prob.add_goal(InitialForceEquilibriumGoal(
                name="initial_force_equilibrium"))
    prob.set_control_info("/forceset/muscle", (0.01, 1))
    prob.add_goal(FinalTimeGoal(name="time"))

    study = Study(prob)
    study.set_solver_options(transcription_scheme=scheme,
                             num_mesh_intervals=num_mesh_intervals,
                             multibody_dynamics_mode=multibody_dynamics_mode)
    study.set_ipm_options(tol=1e-4)
    return study


def kirk_min_effort_study(num_mesh_intervals=50, scheme="hermite-simpson"):
    """Kirk 1998 example 5.1-1 (reference testMocoAnalytic.cpp): a unit
    mass with a negative damper (F = +u) driven from rest at 0 to 5 m and
    2 m/s in 2 s with minimum effort."""
    b = MechModelBuilder(gravity=(0.0, 0.0, 0.0))
    b.add_body("b", mass=1.0, joint_name="j", kind="prismatic",
               axis=(1, 0, 0), coord_name="coord")
    model = Model(b.finalize())
    model.add_spring_generalized_force("damper", "coord", viscosity=-1.0)
    model.add_coordinate_actuator("actuator", "coord", optimal_force=1.0)
    model.finalize()

    prob = Problem(model)
    prob.set_time_bounds(0, 2)
    prob.set_state_info("/jointset/j/coord/value", (-10, 10), 0, 5)
    prob.set_state_info("/jointset/j/coord/speed", (-10, 10), 0, 2)
    prob.set_control_info("/forceset/actuator", (-50, 50))
    prob.add_goal(ControlGoal(name="effort", weight=0.5))

    study = Study(prob)
    study.set_solver_options(transcription_scheme=scheme,
                             num_mesh_intervals=num_mesh_intervals)
    return study


def double_pendulum_swingup_study(num_mesh_intervals=25,
                                  scheme="hermite-simpson",
                                  with_path_constraint=False):
    """Double-pendulum swing-up with torque actuators (reference
    testMocoInterface.cpp double pendulum; the BASELINE configuration adds
    a control-effort goal and optionally a path constraint on the elbow
    angle): from hanging at rest to inverted at rest in 1 s."""
    b = MechModelBuilder(gravity=(0, -9.81, 0))
    b.add_body("link1", mass=1.0, com=(0, -0.5, 0),
               inertia=np.diag([0, 0, 1.0 / 12.0]), joint_name="j0",
               kind="revolute", axis=(0, 0, 1), coord_name="q0")
    b.add_body("link2", mass=1.0, com=(0, -0.5, 0),
               inertia=np.diag([0, 0, 1.0 / 12.0]), parent="link1",
               joint_name="j1", kind="revolute", axis=(0, 0, 1),
               tree_r=(0, -1.0, 0), coord_name="q1")
    model = Model(b.finalize())
    model.add_coordinate_actuator("tau0", "q0", optimal_force=1.0,
                                  min_control=-100, max_control=100)
    model.add_coordinate_actuator("tau1", "q1", optimal_force=1.0,
                                  min_control=-100, max_control=100)
    model.finalize()

    prob = Problem(model)
    prob.set_time_bounds(0, 1.0)
    # start hanging at rest; end inverted (tip up): q0 = pi, q1 = 0
    prob.set_state_info("/jointset/j0/q0/value", (-10, 10), 0, np.pi)
    prob.set_state_info("/jointset/j1/q1/value", (-10, 10), 0, 0)
    prob.set_state_info("/jointset/j0/q0/speed", (-50, 50), 0, 0)
    prob.set_state_info("/jointset/j1/q1/speed", (-50, 50), 0, 0)
    prob.add_goal(ControlGoal(name="effort", weight=0.001))
    if with_path_constraint:
        # keep the elbow angle within [-2, 2] along the path
        def elbow_limit(rep, t, y, x, lam, p):
            return y[..., rep.state_index("/jointset/j1/q1/value")]

        prob.add_path_constraint("elbow_range", elbow_limit, -2.0, 2.0)

    study = Study(prob)
    study.set_solver_options(transcription_scheme=scheme,
                             num_mesh_intervals=num_mesh_intervals)
    return study


def oscillator_mass_study(num_mesh_intervals=40, goal_mode="cost"):
    """Optimize a body's mass (the JAX package's
    ``test_parameters.py::test_optimize_oscillator_mass``, after reference
    testMocoParameters.cpp): a unit spring, q(0) = 1, u(0) = 0, no
    forcing, so q(t) = cos(t / sqrt(m)), and m = 1 is the answer.

    ``goal_mode="cost"``: the JAX test's problem, m in [0.1, 10] and a
    custom cost (q(pi) + 1)^2 + u(pi)^2 whose ``value_fn`` sends it to the
    dense KKT path. ``"endpoint_constraint"``: the structured form, with
    the parameter and an endpoint-constraint row in the KKT border
    (k = 2): the cost tracks the m = 1 motion, an integrand (block-local),
    and the initial rest u(0) = 0 moves from a bound to a custom
    endpoint-constraint row. A row on the final state instead
    (u(pi) = 0) would leave no degree of freedom, a square system that
    the IPM does not solve from jittered starts (no lane of three at mesh
    40); m narrows to [0.5, 2], where the tracking cost has no other
    minimum (from [0.1, 10], 3 jittered lanes of 8 stall near m = 5 at
    mesh 40)."""
    b = MechModelBuilder(gravity=(0.0, 0.0, 0.0))
    b.add_body("osc", mass=3.0, joint_name="j", kind="prismatic",
               axis=(1, 0, 0), coord_name="q")
    model = Model(b.finalize())
    model.add_spring_generalized_force("spring", "q", stiffness=1.0)
    model.finalize()

    prob = Problem(model)
    prob.set_time_bounds(0, np.pi)
    prob.set_state_info("/jointset/j/q/value", (-5, 5), 1.0)

    def apply_mass(p, theta):  # out of place: runs under torch.func
        mech = dict(p["mech"])
        mech["mass"] = torch.cat([theta.reshape(1), mech["mass"][1:]])
        return {**p, "mech": mech}

    if goal_mode == "cost":
        prob.set_state_info("/jointset/j/q/speed", (-5, 5), 0.0)
        prob.add_parameter("osc_mass", (0.1, 10.0), apply_mass,
                           initial_value=3.0)
        prob.add_goal(CustomGoal(
            name="endpoint_match",
            value_fn=lambda rep, initial, final, integral, p:
            (final[1][..., 0] + 1.0) ** 2 + final[1][..., 1] ** 2))
    elif goal_mode == "endpoint_constraint":
        prob.set_state_info("/jointset/j/q/speed", (-5, 5))
        prob.add_parameter("osc_mass", (0.5, 2.0), apply_mass,
                           initial_value=3.0)
        prob.add_goal(CustomGoal(
            name="track",
            integrand_fn=lambda rep, t, y, x, lam, p:
            (y[..., 0] - torch.cos(t)) ** 2))
        prob.add_goal(CustomGoal(
            name="initial_rest", mode="endpoint_constraint",
            value_fn=lambda rep, initial, final, integral, p:
            initial[1][..., 1]))
    else:
        raise ValueError(goal_mode)

    study = Study(prob)
    study.set_solver_options(num_mesh_intervals=num_mesh_intervals)
    study.set_ipm_options(tol=1e-8, max_iter=500)
    return study


def coupler_pendulum_study(num_mesh_intervals=15,
                           scheme="hermite-simpson",
                           enforce_constraint_derivatives=True):
    """Double pendulum with q1 = q0 enforced by a kinematic constraint
    (the JAX package's
    ``test_constraints.py::test_coupler_constrained_double_pendulum``,
    after reference testConstraints.cpp): swing from rest at 0 to rest at
    q0 = 0.6 in 1 s with minimum effort."""
    b = MechModelBuilder(gravity=(0, -9.81, 0))
    b.add_body("link1", mass=1.0, com=(0, -0.5, 0),
               inertia=np.diag([0, 0, 1.0 / 12]), joint_name="j0",
               kind="revolute", axis=(0, 0, 1), coord_name="q0")
    b.add_body("link2", mass=1.0, com=(0, -0.5, 0), parent="link1",
               joint_name="j1", kind="revolute", axis=(0, 0, 1),
               tree_r=(0, -1.0, 0), coord_name="q1")
    model = Model(b.finalize())
    model.add_coordinate_actuator("tau0", "q0", optimal_force=1.0,
                                  min_control=-100, max_control=100)
    model.add_coordinate_actuator("tau1", "q1", optimal_force=1.0,
                                  min_control=-100, max_control=100)
    model.add_kinematic_constraint(
        "coupler", lambda mp, q: q[..., 1:2] - q[..., 0:1])
    model.finalize()

    prob = Problem(model)
    prob.set_time_bounds(0, 1)
    prob.set_state_info("/jointset/j0/q0/value", (-5, 5), 0, 0.6)
    prob.set_state_info("/jointset/j1/q1/value", (-5, 5), 0)
    prob.set_state_info("/jointset/j0/q0/speed", (-20, 20), 0, 0)
    prob.set_state_info("/jointset/j1/q1/speed", (-20, 20), 0)
    prob.add_goal(ControlGoal(name="effort", weight=0.5))
    study = Study(prob)
    study.set_solver_options(
        transcription_scheme=scheme, num_mesh_intervals=num_mesh_intervals,
        enforce_constraint_derivatives=enforce_constraint_derivatives)
    study.set_ipm_options(tol=1e-6, max_iter=500)
    return study


def contact_leg_study(num_mesh_intervals=50):
    """A planar one-legged stance on two contact spheres tracking one squat
    cycle in 1 s (``example_models/contact_leg.py``: a pelvis on a
    three-coordinate custom joint, a revolute hip, a spline-coupled custom
    knee, a revolute ankle, four DGF muscles with activation dynamics,
    residuals and reserves): coordinate tracking, effort with heavy
    residual weights, periodicity of every state but ``pelvis_tx/value``
    as endpoint constraints, and sagittal GRF tracking; Hermite-Simpson
    at ``num_mesh_intervals`` (gait2d's 50 by default)."""
    from . import ocp
    from .example_models import contact_leg as leg
    from .utils.splines import CubicSpline

    model = leg.build_leg(MechModelBuilder, Model, CubicSpline, dgf)
    return leg.build_study(ocp, model, num_mesh_intervals)


def contact_leg_track_study(num_mesh_intervals=50):
    """The contact leg's squat through the ``Track`` tool, in the shape of
    the JAX package's ``gait2d_tracking_study`` (``examples.py:238``): the
    reference coordinates as a ``StoTable`` (low-passed at 6 Hz, speeds
    from finite differences) and the leg's markers from a .trc (one
    marker blank in a few frames, one on no body), tracked at
    ``TRACKING_WEIGHT`` and 1; then the leg's effort, periodicity and GRF
    goals and its bounds (``example_models/contact_leg.py``
    ``add_goals_and_bounds``). Returns ``(study, guess)``, the guess
    ``Track.make_guess``."""
    import io

    from . import ocp
    from .example_models import contact_leg as leg
    from .tools.track import Track
    from .utils.splines import CubicSpline
    from .utils.tables import StoTable, read_trc

    model = leg.build_leg(MechModelBuilder, Model, CubicSpline, dgf)
    t, q, _ = leg.reference()
    table = StoTable(t, [f"{leg.coordinate_path(c)}/value"
                         for c in leg.COORDS], q)
    track = Track(model=model, states_reference=table,
                  states_global_weight=leg.TRACKING_WEIGHT,
                  track_reference_position_derivatives=True,
                  lowpass_cutoff=6.0, initial_time=0.0,
                  final_time=leg.DURATION,
                  mesh_interval=leg.DURATION / num_mesh_intervals,
                  control_effort_weight=0.0,
                  markers_reference=read_trc(io.StringIO(
                      leg.marker_trc_text())),
                  allow_unused_references=True)
    study = track.build_study()
    leg.add_goals_and_bounds(ocp, study.problem, model)
    return study, track.make_guess(study)


def _gait2d_symmetry_goal(model):
    """Half-cycle symmetry pairs shared by gaitTracking and gaitPrediction
    (example2DWalking.cpp:84-131 and :228-275; JAX ``examples.py:175``)."""
    from .ocp import PeriodicityGoal

    state_pairs = []
    for c in model.coordinate_paths():
        cname = c.split("/")[-1]
        for suffix in ("/value", "/speed"):
            if cname.endswith("_r"):
                state_pairs.append((c + suffix,
                                    c.replace("_r", "_l") + suffix, False))
            elif cname.endswith("_l"):
                state_pairs.append((c + suffix,
                                    c.replace("_l", "_r") + suffix, False))
            elif not cname.endswith("_tx"):
                state_pairs.append((c + suffix, c + suffix, False))
    state_pairs.append(("/jointset/groundPelvis/pelvis_tx/speed",
                        "/jointset/groundPelvis/pelvis_tx/speed", False))
    for m in model.muscles:
        a = f"/forceset/{m.name}/activation"
        if m.name.endswith("_r"):
            state_pairs.append((a, a.replace("_r", "_l"), False))
        elif m.name.endswith("_l"):
            state_pairs.append((a, a.replace("_l", "_r"), False))
    return PeriodicityGoal(name="symmetry", state_pairs=tuple(state_pairs),
                           control_pairs=(("/forceset/lumbarAct",
                                           "/forceset/lumbarAct", False),))


def _gait2d_state_bounds(prob):
    """Coordinate bounds shared by gaitTracking and gaitPrediction
    (example2DWalking.cpp:154-170 and :282-303; JAX ``examples.py:203``)."""
    d = np.pi / 180
    prob.set_state_info("/jointset/groundPelvis/pelvis_tilt/value",
                        (-20 * d, -10 * d))
    prob.set_state_info("/jointset/groundPelvis/pelvis_tx/value", (0, 1))
    prob.set_state_info("/jointset/groundPelvis/pelvis_ty/value",
                        (0.75, 1.25))
    for s in ("l", "r"):
        prob.set_state_info(f"/jointset/hip_{s}/hip_flexion_{s}/value",
                            (-10 * d, 60 * d))
        prob.set_state_info(f"/jointset/knee_{s}/knee_angle_{s}/value",
                            (-50 * d, 0))
        prob.set_state_info(f"/jointset/ankle_{s}/ankle_angle_{s}/value",
                            (-15 * d, 25 * d))
    prob.set_state_info("/jointset/lumbar/lumbar/value", (0, 20 * d))


def walker2d_track_study(num_mesh_intervals=50):
    """The planar 18-muscle walker of ``example_models/walker2d.py`` through
    the ``Track`` tool, step for step as the JAX package's
    ``gait2d_tracking_study`` (``examples.py:238``), which reads gait2d's
    files: the reference coordinates as a ``StoTable`` (low-passed at 6 Hz,
    speeds from finite differences) tracked at weight 10, control effort
    at 10, tolerance 1e-4, over the half gait cycle; then the half-cycle
    symmetry rows, the two feet's sagittal GRF tracking at weight 1 and
    gait2d's coordinate bounds. Returns ``(study, guess)``, the guess
    ``Track.make_guess``."""
    from .example_models import walker2d
    from .ocp import ContactTrackingGoal
    from .tools.track import Track
    from .utils.splines import CubicSpline
    from .utils.tables import StoTable

    model = walker2d.build_walker(MechModelBuilder, Model, CubicSpline, dgf)
    t, q = walker2d.reference()
    ref = StoTable(t, [f"{walker2d.coordinate_path(c)}/value"
                       for c in walker2d.COORDS], q)
    final_time = walker2d.HALF_CYCLE
    track = Track(model=model, states_reference=ref,
                  states_global_weight=10.0, control_effort_weight=10.0,
                  track_reference_position_derivatives=True,
                  initial_time=0.0, final_time=final_time,
                  mesh_interval=final_time / num_mesh_intervals,
                  convergence_tolerance=1e-4, lowpass_cutoff=6.0)
    study = track.build_study()
    prob = study.problem
    prob.add_goal(_gait2d_symmetry_goal(model))
    prob.add_goal(ContactTrackingGoal(
        name="contact", weight=1.0,
        groups=((("contactHeel_r", "contactFront_r"), "Right_GRF"),
                (("contactHeel_l", "contactFront_l"), "Left_GRF")),
        reference=walker2d.grf_reference(),
        projection="plane", projection_vector=(0.0, 0.0, 1.0)))
    _gait2d_state_bounds(prob)
    return study, track.make_guess(study)


def walker2d_reference_trajectory():
    """The walker's reference motion over the tracked half cycle [0, T]
    (``example_models/walker2d.py``) as a
    :class:`~opensim_moco_tpu_torch.utils.trajectory.Trajectory`: the
    coordinates and their finite-difference speeds, no controls. A warm
    start for ``walker2d_prediction_study`` that needs no tracking
    solve."""
    from .example_models import walker2d
    from .utils.trajectory import Trajectory

    t, q = walker2d.reference()
    keep = (t >= -1e-12) & (t <= walker2d.HALF_CYCLE + 1e-12)
    t, q = t[keep], q[keep]
    paths = [walker2d.coordinate_path(c) for c in walker2d.COORDS]
    return Trajectory(
        time=t, state_names=[f"{p}/value" for p in paths] +
        [f"{p}/speed" for p in paths],
        states=np.concatenate([q, np.gradient(q, t, axis=0)], axis=1),
        control_names=[], controls=np.zeros((len(t), 0)))


def walker2d_prediction_study(num_mesh_intervals=10, desired_speed=1.2,
                              effort_weight=10.0, tol=1e-4,
                              max_iterations=1000, guess=None):
    """De-novo gait prediction on the planar walker of
    ``example_models/walker2d.py``, step for step as the JAX package's
    ``gait2d_prediction_study`` (``examples.py:291``, the reference's
    example2DWalking gaitPrediction), which reads gait2d's files: a free
    final time in [0.4, 0.6], the half-cycle symmetry rows, the average
    speed of the center of mass held at ``desired_speed`` (an endpoint
    constraint), the cubed control effort over the center of mass's
    displacement at ``effort_weight`` (no tracking data), gait2d's
    coordinate bounds; Hermite-Simpson, ``objective-only`` curvature.
    Dividing by the displacement couples every time block with the
    endpoints, so the problem takes the dense KKT path.

    The walker's three pelvis residuals and ``lumbarAct``, which gait2d
    lacks, are in the effort goal with weight 1 per control, as in
    ``walker2d_track_study``'s effort goal (every control at weight 1).

    ``guess`` (a ``Trajectory``, such as a tracking ``Solution``, or a
    flat iterate) is passed on: a ``Trajectory`` goes through
    ``Transcription.guess_from_trajectory``. The reference warm-starts
    from the tracking solution (example2DWalking.cpp:314-315): the cold
    bounds-midpoint guess has no displacement. Returns ``(study,
    guess)``, the guess None when none is given."""
    from .example_models import walker2d
    from .ocp import AverageSpeedGoal
    from .utils.splines import CubicSpline

    model = walker2d.build_walker(MechModelBuilder, Model, CubicSpline, dgf)
    prob = Problem(model)
    prob.set_time_bounds(0, (0.4, 0.6))
    prob.add_goal(_gait2d_symmetry_goal(model))
    prob.add_goal(AverageSpeedGoal(name="speed", use_com=True,
                                   desired_speed=desired_speed,
                                   mode="endpoint_constraint"))
    prob.add_goal(ControlGoal(name="effort", weight=effort_weight,
                              exponent=3, divide_by_displacement=True))
    _gait2d_state_bounds(prob)

    study = Study(prob)
    study.set_solver_options(transcription_scheme="hermite-simpson",
                             num_mesh_intervals=num_mesh_intervals)
    study.set_ipm_options(tol=tol, max_iter=max_iterations,
                          hessian_approximation="objective-only")
    if guess is not None and hasattr(guess, "state_names"):
        guess = study.transcription().guess_from_trajectory(guess)
    return study, guess


def walker2d_inverse_model():
    """The model of :func:`walker2d_inverse_study`
    (``walker2d.build_inverse_walker`` with the port's classes)."""
    from .example_models import walker2d
    from .models.wrap import WrapCylinderSpec
    from .utils.processors import ModOpAddExternalLoads
    from .utils.splines import CubicSpline

    return walker2d.build_inverse_walker(MechModelBuilder, Model,
                                         CubicSpline, dgf, WrapCylinderSpec,
                                         ModOpAddExternalLoads)


def walker2d_inverse_study(mesh_interval=0.01):
    """MocoInverse on the walker, step for step as the JAX package's
    ``gait_inverse_study`` (``examples.py:387``; reference
    testMocoInverse.cpp:118-147), which reads the subject's files: DGF
    muscles with implicit tendon compliance and no passive fiber force,
    the measured GRFs as external loads (:func:`walker2d_inverse_model`),
    every coordinate prescribed from the reference motion low-passed at 6
    Hz over the half cycle [0, T], and the ``Inverse`` tool at tolerance
    1e-3; the leg's reserves weighted ``walker2d.RESERVES_WEIGHT`` in the
    effort, as the arm's in ``tests/inverse_arm.py``. Returns the
    study."""
    from .example_models import walker2d
    from .tools.inverse import Inverse
    from .utils.processors import filter_lowpass
    from .utils.tables import StoTable

    model = walker2d_inverse_model()
    t, q = walker2d.reference()
    kin = filter_lowpass(StoTable(t, list(walker2d.COORDS), q), 6.0)
    return Inverse(model=model, kinematics=(kin.time, kin.data),
                   initial_time=0.0, final_time=walker2d.HALF_CYCLE,
                   mesh_interval=mesh_interval, convergence_tolerance=1e-3,
                   reserves_weight=walker2d.RESERVES_WEIGHT).build_study()
