"""Inverse tool: muscle activity from observed kinematics.

Counterpart of ``opensim_moco_tpu.tools.inverse`` (the reference's
MocoInverse): every coordinate is prescribed by a quintic-spline
PositionMotion built from a kinematics table, the problem minimizes the
control effort (reserves weighted by name pattern), and it is solved with
the implicit-auxiliary-derivative penalty and the objective's curvature
only, with the JAX package's solver and IPM options.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ocp import ControlGoal, InitialActivationGoal, Problem, Study
from ..ocp.goals import SumSquaredStateGoal


@dataclasses.dataclass
class Inverse:
    """Configure and run an inverse problem (JAX
    ``tools/inverse.py:21-103``). ``kinematics`` is ``(times (K,),
    values (K, nq))`` in the model's coordinate order (radians), or a
    :class:`~opensim_moco_tpu_torch.utils.tables.StoTable` whose columns
    are the coordinates' value paths."""

    model: object = None
    kinematics: object = None
    initial_time: float | None = None
    final_time: float | None = None
    mesh_interval: float = 0.02  # s (the reference's default)
    convergence_tolerance: float = 1e-3
    reserves_weight: float = 1.0
    minimize_sum_squared_activations: bool = False
    max_iterations: int = 2000

    def _kinematics_arrays(self):
        kin = self.kinematics
        if hasattr(kin, "column_names"):  # StoTable
            names = [f"{c}/value" for c in self.model.coordinate_paths()]
            vals = np.stack([kin.column(n) for n in names], axis=1)
            return np.asarray(kin.time), vals
        times, values = kin
        return np.asarray(times), np.asarray(values)

    def build_study(self) -> Study:
        times, values = self._kinematics_arrays()
        # dependent coordinates of couplers onto the constraint manifold,
        # q_dep(t) = f(q_ind(t)): a table's dependent columns may be stale
        if self.model.couplers:
            values = np.array(values, dtype=np.float64, copy=True)
            for di, ii, fn in self.model.couplers:
                values[:, di] = fn(torch.as_tensor(values[:, ii])).numpy()
        t0 = self.initial_time if self.initial_time is not None else times[0]
        tf = self.final_time if self.final_time is not None else times[-1]
        model = self.model
        model.set_position_motion_from_table(times, values)
        model.finalize()

        prob = Problem(model)
        prob.set_time_bounds(t0, tf)
        effort = ControlGoal(name="excitation_effort")
        if self.reserves_weight != 1.0:
            effort.pattern_weights = {".*reserve.*": self.reserves_weight}
        prob.add_goal(effort)
        if any(not m.ignore_activation_dynamics for m in model.muscles):
            prob.add_goal(InitialActivationGoal(name="initial_activation"))
        if self.minimize_sum_squared_activations:
            prob.add_goal(SumSquaredStateGoal(
                name="activation_effort", pattern=".*activation"))

        study = Study(prob)
        n_int = max(2, int(round((tf - t0) / self.mesh_interval)))
        study.set_solver_options(
            transcription_scheme="hermite-simpson",
            num_mesh_intervals=n_int,
            interpolate_control_midpoints=False,
            minimize_implicit_auxiliary_derivatives=True,
            implicit_auxiliary_derivatives_weight=0.01,
        )
        # the JAX package's options: its KKT-error scaling is stricter than
        # IPOPT's, so the user's tolerance maps to tol/100; mu_init 1e-2
        # keeps the bounds-midpoint start in the reference's basin; the
        # constraints' curvature is dropped, as the reference's
        # limited-memory BFGS never sees it either
        study.set_ipm_options(tol=self.convergence_tolerance * 1e-2,
                              max_iter=self.max_iterations,
                              mu_init=1e-2,
                              hessian_approximation="objective-only")
        return study

    def solve(self, device="cuda", dtype=torch.float64):
        """Build the study and solve it on ``device`` (the card unless the
        caller asks for the CPU)."""
        return self.build_study().solve(device, dtype)
