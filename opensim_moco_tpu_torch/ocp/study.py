"""Study: problem + solver facade (MocoStudy analogue).

Counterpart of ``opensim_moco_tpu.ocp.study.Study``: ``solve`` transcribes
the problem, builds the solver on a device (the card unless the caller
asks for the CPU), scales the NLP at the initial guess, runs one lane,
in one go or in chunks with a snapshot written after each and a file
whose deletion stops the solve, and expands the flat solution into a
:class:`~opensim_moco_tpu_torch.utils.trajectory.Solution` of numpy
arrays, sealed when the solve did not converge. The guesses (bounds,
random, time-stepping, from a file) and the diagnostics (the objective's
terms, the constraint violations, outputs along a solution) come with it.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch

from ..config import resolve_device
from ..solver.ipm import IPMOptions, make_chunked_solver, make_solver
from ..transcribe.transcription import SolverOptions, Transcription
from ..utils.rollout import rollout
from ..utils.tables import StoTable, sto_to_trajectory, trajectory_to_sto
from ..utils.trajectory import Solution
from .problem import Problem


class Study:
    def __init__(self, problem: Problem | None = None):
        self.problem = problem if problem is not None else Problem()
        self.solver_options = SolverOptions()
        self.ipm_options = IPMOptions(tol=1e-6, max_iter=1000)

    def update_problem(self) -> Problem:
        return self.problem

    def set_solver_options(self, **kwargs):
        self.solver_options = dataclasses.replace(self.solver_options,
                                                  **kwargs)

    def set_ipm_options(self, **kwargs):
        self.ipm_options = dataclasses.replace(self.ipm_options, **kwargs)

    def transcription(self) -> Transcription:
        return Transcription(self.problem.create_rep(), self.solver_options)

    def _solution_iterate(self, tr, solution):
        """The flat iterate of a solution: its ``raw_iterate``, else the
        trajectory taken onto the grid (``guess_from_trajectory``)."""
        z = getattr(solution, "raw_iterate", None)
        return z if z is not None else tr.guess_from_trajectory(solution)

    def objective_breakdown(self, solution, device="cuda"):
        """{goal name: weighted cost term} at a solution
        (printObjectiveBreakdown), evaluated on ``device``."""
        tr = self.transcription()
        return tr.objective_breakdown(self._solution_iterate(tr, solution),
                                      device)

    def print_constraint_values(self, solution, device="cuda"):
        """Print and return {constraint group: max |violation|} at a
        solution (printConstraintValues), evaluated on ``device``."""
        tr = self.transcription()
        rep_vals = tr.constraint_report(self._solution_iterate(tr, solution),
                                        device)
        for name, v in rep_vals.items():
            print(f"  {name:<28s} max |violation| = {v:.3e}")
        return rep_vals

    def analyze(self, solution, outputs, device="cuda"):
        """Outputs along a solution (MocoStudy::analyze) as a
        :class:`~opensim_moco_tpu_torch.utils.tables.StoTable` over the grid
        times. ``outputs`` maps a column name to a closure in
        ``OutputGoal``'s convention, ``fn(rep, t, y, x, lam, p)`` on the
        grid's tensors on ``device`` (``t`` (G,), ``y`` (G, ny), ...),
        returning (G,) (column ``name``) or (G, k) (columns ``name_0`` to
        ``name_{k-1}``)."""
        dev = resolve_device(device)
        tr = self.transcription()
        rep = tr.rep
        z = torch.as_tensor(np.asarray(self._solution_iterate(tr, solution)),
                            dtype=torch.float64, device=dev)
        t0, tf, Y, X, L, _, _, _, _, theta = tr.unpack(z)
        p = rep.apply_parameters(theta, rep.model.default_params(dev))
        ts = t0 + (tf - t0) * torch.as_tensor(tr.taus, device=dev)
        names, cols = [], []
        for name, fn in outputs.items():
            vals = fn(rep, ts, Y, X, L, p).detach().cpu().numpy()
            if vals.ndim == 1:
                names.append(name)
                cols.append(vals)
            else:
                for k in range(vals.shape[1]):
                    names.append(f"{name}_{k}")
                    cols.append(vals[:, k])
        return StoTable(ts.cpu().numpy(), names, np.stack(cols, axis=1),
                        {"inDegrees": "no"})

    def create_guess(self, kind="bounds", seed=0, substeps=10,
                     device="cuda"):
        """A flat numpy initial iterate (createGuess, JAX
        ``ocp/study.py:97``):

        - ``"bounds"``: the bounds midpoint (``initial_guess``);
        - ``"random"``: that plus uniform perturbations within 10% of each
          variable's range, clipped to the bounds, from numpy's generator
          seeded with ``seed`` (the JAX package's calls, so the same seed
          gives the same iterate);
        - ``"time-stepping"``: the states of an RK4 rollout on ``device``
          (``substeps`` a grid interval) from the midpoint's first state
          under the midpoint's controls, clipped into the state bounds so
          that the barrier starts inside; a prescribed model has no states
          to integrate and gets the bounds guess."""
        dev = resolve_device(device)
        tr = self.transcription()
        z = np.array(tr.initial_guess())
        if kind == "bounds":
            return z
        if kind == "random":
            lb, ub = tr.bounds()
            rng = np.random.default_rng(seed)
            span = np.where(np.isfinite(ub - lb), ub - lb, 1.0)
            return np.clip(z + 0.1 * span * rng.uniform(-1, 1, z.shape),
                           lb, ub)
        if kind == "time-stepping":
            rep = tr.rep
            model = rep.model
            if model.prescribed:
                return z
            t0, tf, Y, X, _, _, _, _, _, theta = tr.unpack(z)
            ts = t0 + (tf - t0) * np.asarray(tr.taus)
            p = rep.apply_parameters(torch.as_tensor(theta, device=dev),
                                     model.default_params(dev))
            traj = rollout(model, p, ts, X, torch.as_tensor(Y[0], device=dev),
                           substeps=substeps).cpu().numpy()
            lb, ub = tr.bounds()
            o = tr.offsets["states"]
            z[o[0]:o[1]] = np.clip(traj.ravel(), lb[o[0]:o[1]],
                                   ub[o[0]:o[1]])
            return z
        raise NotImplementedError(kind)

    def create_guess_from_file(self, path):
        """A flat numpy iterate from a solution or trajectory .sto (the
        reference's guess_file), taken onto this study's grid by
        ``guess_from_trajectory``."""
        tr = self.transcription()
        return tr.guess_from_trajectory(sto_to_trajectory(path).unseal())

    def solve(self, device="cuda", dtype=torch.float64, guess=None,
              checkpoint_interval=None, checkpoint_path=None,
              interrupt_file=None) -> Solution:
        """Solve from ``guess`` on ``device`` (the card unless the caller
        asks for the CPU). ``guess`` is a flat numpy iterate, a
        :class:`~opensim_moco_tpu_torch.utils.trajectory.Trajectory` (or
        ``Solution``), resampled onto this grid by
        ``Transcription.guess_from_trajectory``, or None for the
        bounds-midpoint guess.

        With ``checkpoint_interval`` K or ``interrupt_file`` the solve runs
        in chunks of K iterations (25 without K; JAX
        ``ocp/study.py:190-206``, the same iterates as one solve): after
        each chunk the current best iterate is written to
        ``checkpoint_path`` (.sto, ``trajectory_to_sto``; the reference's
        output_interval), and the solve stops after the chunk at which
        ``interrupt_file`` no longer exists (the reference's
        FileDeletionThrower)."""
        dev = resolve_device(device)
        tr = self.transcription()
        if guess is None:
            z0 = tr.initial_guess()
        elif hasattr(guess, "state_names"):
            z0 = tr.guess_from_trajectory(guess)
        else:
            z0 = np.asarray(guess)
        start = time.perf_counter()
        nlp = tr.make_nlp(dev, dtype)

        def lane0(res):
            return [t[0].cpu().numpy() for t in
                    (res.z, res.f, res.kkt_error, res.iterations,
                     res.converged)]

        if checkpoint_interval or interrupt_file:
            init_fn, run_chunk, finalize_fn = make_chunked_solver(
                nlp, self.ipm_options, z0, device=dev, dtype=dtype)
            carry = init_fn(z0[None])
            chunk = int(checkpoint_interval or 25)
            limit = chunk
            while True:
                carry = run_chunk(carry, limit)
                out = lane0(finalize_fn(carry))
                it, conv = int(out[3]), bool(out[4])
                if checkpoint_path:
                    snap = self.expand(tr, *out,
                                       time.perf_counter() - start)
                    trajectory_to_sto(snap.unseal(), checkpoint_path)
                if conv or it >= self.ipm_options.max_iter:
                    break
                if interrupt_file and not os.path.exists(interrupt_file):
                    break
                limit = it + chunk
        else:
            solve = make_solver(nlp, self.ipm_options, scale_z0=z0,
                                device=dev, dtype=dtype)
            out = lane0(solve(z0[None]))
        return self.expand(tr, *out, time.perf_counter() - start)

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
