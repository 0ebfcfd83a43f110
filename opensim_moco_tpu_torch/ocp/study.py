"""Study: problem + solver facade (MocoStudy analogue).

Counterpart of ``opensim_moco_tpu.ocp.study.Study`` on its non-chunked
path: ``solve`` transcribes the problem, builds the solver on a device
(the card unless the caller asks for the CPU), scales the NLP at the
initial guess, runs one lane and expands the flat solution into a
:class:`~opensim_moco_tpu_torch.utils.trajectory.Solution` of numpy
arrays, sealed when the solve did not converge.
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
from ..utils.trajectory import Solution
from .problem import Problem


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
        """Solve from ``guess`` on ``device`` (the card unless the caller
        asks for the CPU). ``guess`` is a flat numpy iterate, a
        :class:`~opensim_moco_tpu_torch.utils.trajectory.Trajectory` (or
        ``Solution``), resampled onto this grid by
        ``Transcription.guess_from_trajectory``, or None for the
        bounds-midpoint guess."""
        dev = resolve_device(device)
        tr = self.transcription()
        if guess is None:
            z0 = tr.initial_guess()
        elif hasattr(guess, "state_names"):
            z0 = tr.guess_from_trajectory(guess)
        else:
            z0 = np.asarray(guess)
        start = time.perf_counter()
        solve = make_solver(tr.make_nlp(dev, dtype), self.ipm_options,
                            scale_z0=z0, device=dev, dtype=dtype)
        res = solve(z0[None])
        z, f, kkt, it, conv = (t[0].cpu().numpy() for t in
                               (res.z, res.f, res.kkt_error, res.iterations,
                                res.converged))
        return self.expand(tr, z, f, kkt, it, conv,
                           time.perf_counter() - start)

    def expand(self, tr, z, f, kkt_error, iterations, converged,
               duration=float("nan")) -> Solution:
        """The :class:`Solution` of a flat iterate ``z`` (numpy) of ``tr``
        with the solver's statistics, sealed unless ``converged`` (JAX
        ``ocp/study.py:240``). Derivative columns take the reference's
        names (``<coordinate>/accel``, then
        ``/forceset/<muscle>/implicitderiv_normalized_tendon_force``), so
        that a solution goes back through ``guess_from_trajectory``."""
        rep = tr.rep
        t0, tf, Y, X, L, D, _, _, _, theta = tr.unpack(np.asarray(z))
        converged = bool(converged)
        self._check_constraint_jacobian_rank(tr, Y)
        sol = Solution(
            time=t0 + (tf - t0) * np.asarray(tr.taus),
            state_names=list(rep.state_names), states=Y,
            control_names=list(rep.control_names), controls=X,
            multiplier_names=rep.model.multiplier_names(), multipliers=L,
            derivative_names=tr.derivative_names(), derivatives=D,
            parameter_names=[p.name for p in rep.parameters],
            parameters=theta,
            success=converged,
            status=("converged" if converged else
                    f"max iterations or stall (kkt={float(kkt_error):.2e})"),
            objective=float(f), num_iterations=int(iterations),
            kkt_error=float(kkt_error), solver_duration=duration,
            raw_iterate=np.asarray(z))
        if not converged:
            sol.seal()
        return sol

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
