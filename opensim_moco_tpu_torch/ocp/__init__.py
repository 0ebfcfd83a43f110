from .goals import (ContactTrackingGoal, ControlGoal, CustomGoal,
                    FinalTimeGoal, Goal, InitialActivationGoal,
                    InitialForceEquilibriumGoal,
                    InitialVelocityEquilibriumDGFGoal, MarkerTrackingGoal,
                    PeriodicityGoal, StateTrackingGoal, SumSquaredStateGoal)
from .problem import (ParameterSpec, PathConstraintSpec, Problem,
                      ProblemRep, VariableInfo)
from .study import Solution, Study

__all__ = [
    "Goal", "ControlGoal", "CustomGoal", "FinalTimeGoal", "InitialActivationGoal",
    "InitialForceEquilibriumGoal", "InitialVelocityEquilibriumDGFGoal",
    "SumSquaredStateGoal", "StateTrackingGoal", "PeriodicityGoal",
    "ContactTrackingGoal", "MarkerTrackingGoal",
    "ParameterSpec", "PathConstraintSpec", "Problem", "ProblemRep",
    "VariableInfo", "Solution", "Study",
]
