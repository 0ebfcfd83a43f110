from .goals import (ControlGoal, CustomGoal, FinalTimeGoal, Goal,
                    InitialActivationGoal, InitialForceEquilibriumGoal,
                    InitialVelocityEquilibriumDGFGoal, SumSquaredStateGoal)
from .problem import (ParameterSpec, PathConstraintSpec, Problem,
                      ProblemRep, VariableInfo)
from .study import Solution, Study

__all__ = [
    "Goal", "ControlGoal", "CustomGoal", "FinalTimeGoal", "InitialActivationGoal",
    "InitialForceEquilibriumGoal", "InitialVelocityEquilibriumDGFGoal",
    "SumSquaredStateGoal",
    "ParameterSpec", "PathConstraintSpec", "Problem", "ProblemRep",
    "VariableInfo", "Solution", "Study",
]
