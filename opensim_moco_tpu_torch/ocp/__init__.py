from .goals import (ControlGoal, FinalTimeGoal, Goal, InitialActivationGoal,
                    InitialForceEquilibriumGoal,
                    InitialVelocityEquilibriumDGFGoal)
from .problem import Problem, ProblemRep, VariableInfo
from .study import Solution, Study

__all__ = [
    "Goal", "ControlGoal", "FinalTimeGoal", "InitialActivationGoal",
    "InitialForceEquilibriumGoal", "InitialVelocityEquilibriumDGFGoal",
    "Problem", "ProblemRep", "VariableInfo", "Solution", "Study",
]
