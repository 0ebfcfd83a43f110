"""Example problems on the port's main path.

Counterparts of ``opensim_moco_tpu.examples`` builders, with the same
signatures and the same problems; each returns a ready-to-solve
:class:`~opensim_moco_tpu_torch.ocp.study.Study`.
"""

from __future__ import annotations

from .models import MechModelBuilder
from .models import muscle as dgf
from .models.model import Model
from .ocp import (FinalTimeGoal, InitialActivationGoal,
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
