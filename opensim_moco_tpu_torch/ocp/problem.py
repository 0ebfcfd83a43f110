"""Problem specification and its compiled representation.

Counterpart of ``opensim_moco_tpu.ocp.problem`` (MocoProblem /
MocoProblemRep): name -> index resolution and bounds in system order, all
host-side numpy, plus path constraints and optimizable parameters.

User callables take the port's tensors with leading dimensions, as the
goals do: a path constraint's ``fn(rep, t, y, x, lam, p)`` gets t (..., P),
y (..., P, ny), x (..., P, nx), lam (..., P, nlam) at the P mesh points
and returns (..., P, k) (or (..., P) for one component).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable

import numpy as np

from ..models.model import Model
from .goals import Goal


def _as_bounds(b):
    """Accept scalar (equality), (lo, hi) tuple, or None (unbounded)."""
    if b is None:
        return (-np.inf, np.inf)
    if np.isscalar(b):
        return (float(b), float(b))
    lo, hi = b
    return (float(lo), float(hi))


@dataclasses.dataclass
class VariableInfo:
    """Phase/initial/final bounds for one continuous variable."""
    bounds: tuple = (-np.inf, np.inf)
    initial: tuple | None = None
    final: tuple | None = None


def _info(bounds, initial, final):
    return VariableInfo(_as_bounds(bounds),
                        None if initial is None else _as_bounds(initial),
                        None if final is None else _as_bounds(final))


@dataclasses.dataclass
class PathConstraintSpec:
    """g_L <= g(t, y, x, lam, p) <= g_U at every mesh point
    (MocoPathConstraint; JAX ``ocp/problem.py:45``)."""
    name: str
    fn: Callable  # (rep, t, y, x, lam, p) -> (..., P, k)
    lower: np.ndarray
    upper: np.ndarray


@dataclasses.dataclass
class ParameterSpec:
    """Optimizable time-invariant model parameter (MocoParameter; JAX
    ``ocp/problem.py:55``). ``apply(params, theta)`` returns the parameter
    dict with the scalar tensor ``theta`` put in; it runs under
    ``torch.func`` transforms, so it must not write in place: build the
    new entry with ``torch.cat``/``torch.where`` and return new dicts."""
    name: str
    bounds: tuple
    apply: Callable  # (params dict, theta scalar tensor) -> params dict
    initial_value: float | None = None


class Problem:
    """User-facing problem builder (MocoProblem analogue)."""

    def __init__(self, model: Model | None = None):
        self.model = model
        self.time_initial = (0.0, 0.0)
        self.time_final = (1.0, 1.0)
        self.state_infos: dict[str, VariableInfo] = {}
        self.state_info_patterns: list[tuple[str, VariableInfo]] = []
        self.control_infos: dict[str, VariableInfo] = {}
        self.goals: list[Goal] = []
        self.path_constraints: list[PathConstraintSpec] = []
        self.parameters: list[ParameterSpec] = []
        self.multiplier_bounds = (-1000.0, 1000.0)

    def set_model(self, model: Model):
        self.model = model

    def set_time_bounds(self, initial, final):
        self.time_initial = _as_bounds(initial)
        self.time_final = _as_bounds(final)

    def set_state_info(self, name, bounds=None, initial=None, final=None):
        self.state_infos[name] = _info(bounds, initial, final)

    def set_state_info_pattern(self, pattern, bounds=None, initial=None,
                               final=None):
        """Bounds for every state whose name ``re.fullmatch``es
        ``pattern`` (setStateInfoPattern; JAX ``ocp/problem.py:94``):
        explicit infos take precedence, and patterns are tried in the order
        they were set."""
        self.state_info_patterns.append((pattern,
                                         _info(bounds, initial, final)))

    def set_control_info(self, name, bounds=None, initial=None, final=None):
        self.control_infos[name] = _info(bounds, initial, final)

    def add_goal(self, goal: Goal):
        self.goals.append(goal)
        return goal

    def add_path_constraint(self, name, fn, lower, upper=None):
        """JAX ``ocp/problem.py:112``: equality where ``upper`` is None or
        equals ``lower``, otherwise a slack per mesh point."""
        lower = np.atleast_1d(np.asarray(lower, dtype=float))
        upper = (lower if upper is None
                 else np.atleast_1d(np.asarray(upper, dtype=float)))
        self.path_constraints.append(PathConstraintSpec(name, fn, lower,
                                                        upper))

    def add_parameter(self, name, bounds, apply, initial_value=None):
        """JAX ``ocp/problem.py:119``."""
        self.parameters.append(ParameterSpec(name, _as_bounds(bounds), apply,
                                             initial_value))

    def create_rep(self) -> "ProblemRep":
        return ProblemRep(self)


class ProblemRep:
    """Compiled problem: bounds in system order + goals."""

    def __init__(self, problem: Problem):
        if problem.model is None:
            raise ValueError("Problem has no model")
        if not problem.model._finalized:
            problem.model.finalize()
        self.problem = problem
        self.model = problem.model
        self.state_names = self.model.state_names()
        self.control_names = self.model.control_names()
        self.ny = len(self.state_names)
        self.nx = len(self.control_names)
        self.nlam = self.model.nphi
        self.goals = problem.goals
        self.path_constraints = problem.path_constraints
        self.parameters = problem.parameters
        self.np = len(self.parameters)

        dlo, dhi = self.model.default_state_bounds()
        self.y_lo, self.y_hi = dlo.copy(), dhi.copy()
        self.y0_lo, self.y0_hi = dlo.copy(), dhi.copy()
        self.yf_lo, self.yf_hi = dlo.copy(), dhi.copy()

        def resolve(name):
            info = problem.state_infos.get(name)
            if info is not None:
                return info
            for pat, pinfo in problem.state_info_patterns:
                if re.fullmatch(pat, name):
                    return pinfo
            return None

        for i, name in enumerate(self.state_names):
            info = resolve(name)
            if info is None:
                continue
            self.y_lo[i], self.y_hi[i] = info.bounds
            self.y0_lo[i], self.y0_hi[i] = info.initial or info.bounds
            self.yf_lo[i], self.yf_hi[i] = info.final or info.bounds

        clo, chi = self.model.default_control_bounds()
        self.x_lo, self.x_hi = clo.copy(), chi.copy()
        self.x0_lo, self.x0_hi = clo.copy(), chi.copy()
        self.xf_lo, self.xf_hi = clo.copy(), chi.copy()
        for i, name in enumerate(self.control_names):
            info = problem.control_infos.get(name)
            if info is None:
                continue
            self.x_lo[i], self.x_hi[i] = info.bounds
            self.x0_lo[i], self.x0_hi[i] = info.initial or info.bounds
            self.xf_lo[i], self.xf_hi[i] = info.final or info.bounds

        self.t0_bounds = problem.time_initial
        self.tf_bounds = problem.time_final
        self.lam_bounds = problem.multiplier_bounds
        # parameter bounds and initial values (JAX ocp/problem.py:190-196)
        self.param_lo = np.array([p.bounds[0] for p in self.parameters])
        self.param_hi = np.array([p.bounds[1] for p in self.parameters])
        self.param_init = np.array([
            p.initial_value if p.initial_value is not None
            else 0.5 * (p.bounds[0] + p.bounds[1])
            for p in self.parameters])

    def apply_parameters(self, theta, params):
        """``params`` (the model's parameter dict) with the decision
        parameters ``theta`` (np,) applied in order (JAX
        ``ocp/problem.py:198``)."""
        for k, spec in enumerate(self.parameters):
            params = spec.apply(params, theta[..., k])
        return params

    def state_index(self, name):
        return self.state_names.index(name)

    def control_index(self, name):
        return self.control_names.index(name)
