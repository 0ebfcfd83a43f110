from .goals import (AccelerationTrackingGoal, AngularVelocityTrackingGoal,
                    AverageSpeedGoal, ContactTrackingGoal, ControlGoal,
                    ControlTrackingGoal, CustomGoal, FinalTimeGoal, Goal,
                    InitialActivationGoal, InitialForceEquilibriumGoal,
                    InitialVelocityEquilibriumDGFGoal, JointReactionGoal,
                    MarkerFinalGoal,
                    MarkerTrackingGoal, OrientationTrackingGoal, OutputGoal,
                    PeriodicityGoal, StateTrackingGoal, SumSquaredStateGoal,
                    TranslationTrackingGoal)
from .path_constraints import (control_bound_constraint,
                               frame_distance_constraint)
from .problem import (ParameterSpec, PathConstraintSpec, Problem,
                      ProblemRep, VariableInfo)
from .study import Solution, Study

__all__ = [
    "Goal", "ControlGoal", "CustomGoal", "FinalTimeGoal", "InitialActivationGoal",
    "InitialForceEquilibriumGoal", "InitialVelocityEquilibriumDGFGoal",
    "SumSquaredStateGoal", "StateTrackingGoal", "PeriodicityGoal",
    "ContactTrackingGoal", "MarkerTrackingGoal", "AverageSpeedGoal",
    "MarkerFinalGoal", "ControlTrackingGoal", "TranslationTrackingGoal",
    "OrientationTrackingGoal", "AngularVelocityTrackingGoal", "OutputGoal",
    "AccelerationTrackingGoal", "JointReactionGoal",
    "control_bound_constraint", "frame_distance_constraint",
    "ParameterSpec", "PathConstraintSpec", "Problem", "ProblemRep",
    "VariableInfo", "Solution", "Study",
]
