"""Study: problem + solver facade (MocoStudy analogue).

Counterpart of ``opensim_moco_tpu.ocp.study.Study`` on its non-chunked
path: ``solve`` transcribes the problem, builds the solver on a device
(the card unless the caller asks for the CPU), scales the NLP at the
initial guess, runs one lane and expands the flat solution into a
:class:`Solution` of numpy arrays.
"""

from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..config import resolve_device
from ..solver.ipm import IPMOptions, make_solver
from ..transcribe.transcription import SolverOptions, Transcription
from .problem import Problem


@dataclasses.dataclass
class Solution:
    """Solver output on the transcription grid (MocoSolution analogue)."""
    time: np.ndarray
    state_names: list
    states: np.ndarray  # (G, ny)
    control_names: list
    controls: np.ndarray  # (G, nx)
    success: bool
    status: str
    objective: float
    num_iterations: int
    kkt_error: float
    solver_duration: float
    raw_iterate: np.ndarray
    multiplier_names: list = dataclasses.field(default_factory=list)
    multipliers: np.ndarray | None = None  # (G, nlam)
    parameter_names: list = dataclasses.field(default_factory=list)
    parameters: np.ndarray | None = None  # (np,)

    @property
    def initial_time(self):
        return float(self.time[0])

    @property
    def final_time(self):
        return float(self.time[-1])

    def state(self, name):
        return self.states[:, self.state_names.index(name)]

    def control(self, name):
        return self.controls[:, self.control_names.index(name)]


class Study:
    def __init__(self, problem: Problem | None = None):
        self.problem = problem if problem is not None else Problem()
        self.solver_options = SolverOptions()
        self.ipm_options = IPMOptions(tol=1e-6, max_iter=1000)

    def set_solver_options(self, **kwargs):
        self.solver_options = dataclasses.replace(self.solver_options,
                                                  **kwargs)

    def set_ipm_options(self, **kwargs):
        self.ipm_options = dataclasses.replace(self.ipm_options, **kwargs)

    def transcription(self) -> Transcription:
        return Transcription(self.problem.create_rep(), self.solver_options)

    def solve(self, device="cuda", dtype=torch.float64,
              guess=None) -> Solution:
        """Solve from ``guess`` (flat numpy iterate; default: the
        bounds-midpoint guess) on ``device`` (the card unless the caller
        asks for the CPU)."""
        dev = resolve_device(device)
        tr = self.transcription()
        z0 = tr.initial_guess() if guess is None else np.asarray(guess)
        start = time.perf_counter()
        solve = make_solver(tr.make_nlp(dev, dtype), self.ipm_options,
                            scale_z0=z0, device=dev, dtype=dtype)
        res = solve(z0[None])
        z, f, kkt, it, conv = (t[0].cpu().numpy() for t in
                               (res.z, res.f, res.kkt_error, res.iterations,
                                res.converged))
        duration = time.perf_counter() - start
        rep = tr.rep
        t0, tf, Y, X, L, _, _, _, _, theta = tr.unpack(z)
        converged = bool(conv)
        self._check_constraint_jacobian_rank(tr, Y)
        return Solution(
            time=t0 + (tf - t0) * np.asarray(tr.taus),
            state_names=list(rep.state_names), states=Y,
            control_names=list(rep.control_names), controls=X,
            multiplier_names=rep.model.multiplier_names(), multipliers=L,
            parameter_names=[p.name for p in rep.parameters],
            parameters=theta,
            success=converged,
            status=("converged" if converged
                    else f"max iterations or stall (kkt={float(kkt):.2e})"),
            objective=float(f), num_iterations=int(it),
            kkt_error=float(kkt), solver_duration=duration, raw_iterate=z)

    def _check_constraint_jacobian_rank(self, tr, Y):
        """Post-solve rank check of the kinematic-constraint Jacobian (JAX
        ``ocp/study.py:288``): enforced without its derivatives and without
        multiplier minimization, a rank-deficient G(q) leaves the
        multipliers indeterminate, so log a warning with the same
        guidance. Evaluated on the CPU at up to 9 grid points. Skipped for
        prescribed kinematics, whose q is data (JAX ``ocp/study.py:298``)."""
        rep, opt = tr.rep, tr.opt
        model = rep.model
        if (model.prescribed or not model.nphi or
                opt.enforce_constraint_derivatives or
                opt.minimize_lagrange_multipliers):
            return
        p = rep.apply_parameters(torch.zeros(rep.np, dtype=torch.float64),
                                 model.default_params("cpu"))
        for g in range(0, tr.G, max(1, tr.G // 8)):
            G = model.constraint_jacobian(
                p, torch.as_tensor(Y[g, :model.nq])).numpy()
            rank = int(np.linalg.matrix_rank(G))
            if rank < G.shape[0]:
                dashes = "-" * 52
                log = logging.getLogger("opensim_moco_tpu_torch")
                for line in (
                        dashes,
                        "Rank-deficient constraint Jacobian detected.",
                        dashes,
                        f"The model constraint Jacobian has {G.shape[0]} "
                        f"row(s) but is only rank {rank}.",
                        "Try removing redundant constraints from the model "
                        "or enable",
                        "minimization of Lagrange multipliers by utilizing "
                        "the solver",
                        "properties 'minimize_lagrange_multipliers' and",
                        "'lagrange_multiplier_weight'.",
                        dashes):
                    log.warning(line)
                return
