"""Direct-collocation transcription: OCP -> NLP on tensors.

Counterpart of ``opensim_moco_tpu.transcribe.transcription``. The layout
of the flat decision vector, the bounds and the initial guess are the same
numpy computations as in the JAX package, so they agree exactly::

    [t0, tf,
     states (G, ny) row-major,
     controls (G, nx),
     multipliers (G, nlam),
     derivatives (G, nderiv),          # implicit modes
     slacks gamma (n_intervals, nphi), # HS velocity correction
     path-constraint slacks,
     endpoint-constraint slacks,
     parameters (np,)]

The NLP functions accept decision vectors with any leading dimensions,
``(..., n) -> (..., m)`` and ``(..., n) -> (...)``: the DAE is evaluated on
the whole grid by broadcasting, and the same code serves one lane, a batch
of lanes, a batch of line-search candidates, and ``torch.func`` transforms.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from ..config import resolve_device
from ..solver.nlp import NLP, KKTStructure

if TYPE_CHECKING:
    from ..ocp.problem import ProblemRep


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Transcription settings (MocoDirectCollocationSolver analogue), the
    fields and defaults of the JAX package."""
    transcription_scheme: str = "hermite-simpson"  # | "trapezoidal"
    num_mesh_intervals: int = 25
    mesh: tuple | None = None  # custom normalized mesh (n+1 taus in [0, 1])
    multibody_dynamics_mode: str = "explicit"  # | "implicit"
    enforce_constraint_derivatives: bool = True
    interpolate_control_midpoints: bool = True
    minimize_lagrange_multipliers: bool = False
    lagrange_multiplier_weight: float = 1.0
    velocity_correction_bounds: tuple = (-0.1, 0.1)
    implicit_multibody_acceleration_bounds: tuple = (-1000.0, 1000.0)
    implicit_auxiliary_derivative_bounds: tuple = (-1000.0, 1000.0)
    minimize_implicit_multibody_accelerations: bool = False
    implicit_multibody_accelerations_weight: float = 1.0
    minimize_implicit_auxiliary_derivatives: bool = False
    implicit_auxiliary_derivatives_weight: float = 1.0


class Transcription:
    """Builds the NLP for one ProblemRep + options; provides pack/unpack."""

    def __init__(self, rep: "ProblemRep", options: SolverOptions):
        self.rep = rep
        self.opt = options
        model = rep.model
        self.ny = rep.ny
        self.nx = rep.nx
        self.nq = model.nq
        self.nlam = rep.nlam
        if options.transcription_scheme not in ("hermite-simpson",
                                                "trapezoidal"):
            raise ValueError(options.transcription_scheme)
        self.hermite_simpson = options.transcription_scheme == "hermite-simpson"
        self.prescribed = False
        self.implicit_mb = options.multibody_dynamics_mode == "implicit"
        self.n_zeta = model.n_implicit_aux
        self.nderiv = (self.nq if self.implicit_mb else 0) + self.n_zeta

        if options.mesh is not None:
            mesh = np.asarray(options.mesh, dtype=np.float64)
        else:
            mesh = np.linspace(0.0, 1.0, options.num_mesh_intervals + 1)
        self.mesh = mesh
        self.n_int = len(mesh) - 1
        if self.hermite_simpson:
            taus = np.empty(2 * self.n_int + 1)
            taus[0::2] = mesh
            taus[1::2] = 0.5 * (mesh[:-1] + mesh[1:])
            self.mesh_idx = np.arange(0, len(taus), 2)
            self.mid_idx = np.arange(1, len(taus), 2)
        else:
            taus = mesh
            self.mesh_idx = np.arange(len(taus))
            self.mid_idx = np.arange(0)
        self.taus = taus
        self.G = len(taus)
        self.n_gamma = 0  # no kinematic constraints in the port yet

        w = np.zeros(self.G)
        dtau = np.diff(mesh)
        if self.hermite_simpson:
            for i, h in enumerate(dtau):
                w[2 * i] += h / 6.0
                w[2 * i + 1] += 4.0 * h / 6.0
                w[2 * i + 2] += h / 6.0
        else:
            for i, h in enumerate(dtau):
                w[i] += h / 2.0
                w[i + 1] += h / 2.0
        self.quad_w = w

        self.n_pc_points = len(self.mesh_idx)
        self.pc_slack_specs = []
        self.n_pc_slack = 0

        for g in rep.goals:
            if hasattr(g, "auto_outputs"):
                g.num_outputs = g.auto_outputs(rep)
        self.ec_goals = [g for g in rep.goals
                         if g.mode == "endpoint_constraint"]
        self.cost_goals = [g for g in rep.goals if g.mode == "cost"]
        self.ec_slack_specs = [gi for gi, g in enumerate(self.ec_goals)
                               if g.constraint_bounds[0] !=
                               g.constraint_bounds[1]]
        self.n_ec_slack = sum(self.ec_goals[gi].num_outputs
                              for gi in self.ec_slack_specs)
        self.npar = rep.np

        sizes = {
            "t": 2,
            "states": self.G * self.ny,
            "controls": self.G * self.nx,
            "multipliers": self.G * self.nlam,
            "derivs": self.G * self.nderiv,
            "gamma": self.n_int * self.n_gamma,
            "pc_slack": self.n_pc_slack,
            "ec_slack": self.n_ec_slack,
            "params": self.npar,
        }
        self.offsets = {}
        off = 0
        for k, s in sizes.items():
            self.offsets[k] = (off, off + s)
            off += s
        self.n = off

    # ------------------------------------------------------------- packing
    def unpack(self, z):
        """Split ``z`` (..., n) into (t0, tf, Y, X, L, D, Gm, pcs, ecs,
        theta), each keeping the leading dims."""
        o = self.offsets
        lead = z.shape[:-1]

        def block(k, *shape):
            return z[..., o[k][0]:o[k][1]].reshape(lead + shape)

        return (z[..., 0], z[..., 1],
                block("states", self.G, self.ny),
                block("controls", self.G, self.nx),
                block("multipliers", self.G, self.nlam),
                block("derivs", self.G, self.nderiv),
                block("gamma", self.n_int, self.n_gamma),
                block("pc_slack", self.n_pc_slack),
                block("ec_slack", self.n_ec_slack),
                block("params", self.npar))

    def pack(self, t0, tf, Y, X, L=None, D=None, Gm=None, pcs=None, ecs=None,
             theta=None):
        """Flat numpy decision vector from its blocks (absent blocks are
        zero)."""
        o = self.offsets

        def flat(a, k):
            size = o[k][1] - o[k][0]
            return np.zeros(size) if a is None else np.ravel(a)

        return np.concatenate([
            np.array([float(t0), float(tf)]), np.ravel(Y), np.ravel(X),
            flat(L, "multipliers"), flat(D, "derivs"), flat(Gm, "gamma"),
            flat(pcs, "pc_slack"), flat(ecs, "ec_slack"),
            flat(theta, "params")])

    # ------------------------------------------------------------- bounds
    def bounds(self):
        rep = self.rep
        lb = np.full(self.n, -np.inf)
        ub = np.full(self.n, np.inf)
        lb[0], ub[0] = rep.t0_bounds
        lb[1], ub[1] = rep.tf_bounds

        Ylo = np.tile(rep.y_lo, (self.G, 1))
        Yhi = np.tile(rep.y_hi, (self.G, 1))
        Ylo[0], Yhi[0] = rep.y0_lo, rep.y0_hi
        Ylo[-1], Yhi[-1] = rep.yf_lo, rep.yf_hi
        o = self.offsets
        lb[o["states"][0]:o["states"][1]] = Ylo.ravel()
        ub[o["states"][0]:o["states"][1]] = Yhi.ravel()

        Xlo = np.tile(rep.x_lo, (self.G, 1))
        Xhi = np.tile(rep.x_hi, (self.G, 1))
        if self.G > 0:
            Xlo[0], Xhi[0] = rep.x0_lo, rep.x0_hi
            Xlo[-1], Xhi[-1] = rep.xf_lo, rep.xf_hi
        lb[o["controls"][0]:o["controls"][1]] = Xlo.ravel()
        ub[o["controls"][0]:o["controls"][1]] = Xhi.ravel()

        if self.nderiv:
            dlo = []
            dhi = []
            if self.implicit_mb:
                dlo += [self.opt.implicit_multibody_acceleration_bounds[0]] * \
                    self.nq
                dhi += [self.opt.implicit_multibody_acceleration_bounds[1]] * \
                    self.nq
            dlo += [self.opt.implicit_auxiliary_derivative_bounds[0]] * \
                self.n_zeta
            dhi += [self.opt.implicit_auxiliary_derivative_bounds[1]] * \
                self.n_zeta
            lb[o["derivs"][0]:o["derivs"][1]] = np.tile(dlo, self.G)
            ub[o["derivs"][0]:o["derivs"][1]] = np.tile(dhi, self.G)
        k = 0
        for gi in self.ec_slack_specs:
            g = self.ec_goals[gi]
            for _ in range(g.num_outputs):
                lb[o["ec_slack"][0] + k] = g.constraint_bounds[0]
                ub[o["ec_slack"][0] + k] = g.constraint_bounds[1]
                k += 1
        return lb, ub

    # ----------------------------------------------------------- dynamics
    def _pointwise(self, p, t, y, x, lam, d):
        """DAE on the grid: (ydot (..., G, ny), alg (..., G, n_alg), udot)
        where alg stacks the implicit multibody and implicit auxiliary
        residuals."""
        m = self.rep.model
        q, u, zz = m.split_state(y)
        if self.implicit_mb:
            zeta = d[..., self.nq:]
        else:
            zeta = d[..., :self.n_zeta] if self.n_zeta else None
        alg = []
        if self.implicit_mb:
            udot = d[..., :self.nq]
            alg.append(m.multibody_implicit_residual(p, t, q, u, zz, x, lam,
                                                     udot))
        else:
            udot = m.multibody_explicit(p, t, q, u, zz, x, lam)
        if self.n_zeta:
            alg.append(m.implicit_aux_residuals(p, t, q, u, zz, x, zeta))
        zdot = m.aux_dynamics(p, t, q, u, zz, x, zeta)
        ydot = torch.cat([u, udot, zdot], -1)
        algv = (torch.cat(alg, -1) if alg
                else y.new_zeros(y.shape[:-1] + (0,)))
        return ydot, algv, udot

    def _constants(self, device, dtype):
        """Per-device constants of the NLP functions (made once)."""
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        return {"p": self.rep.model.default_params(dev, dtype),
                "taus": t(self.taus), "dmesh": t(np.diff(self.mesh)),
                "quad_w": t(self.quad_w)}

    @staticmethod
    def _endpoints(ts, Y, X, L, D):
        initial = (ts[..., 0], Y[..., 0, :], X[..., 0, :], L[..., 0, :],
                   D[..., 0, :])
        final = (ts[..., -1], Y[..., -1, :], X[..., -1, :], L[..., -1, :],
                 D[..., -1, :])
        return initial, final

    # ---------------------------------------------------------- constraints
    def constraints_fn(self, device="cuda", dtype=torch.float64):
        """``c(z)``: defects, algebraic residuals and endpoint-constraint
        rows, in the JAX package's row order."""
        rep = self.rep
        C = self._constants(device, dtype)
        p = C["p"]

        def constraints(z):
            t0, tf, Y, X, L, D, Gm, pcs, ecs, theta = self.unpack(z)
            dt = (tf - t0).unsqueeze(-1)
            ts = t0.unsqueeze(-1) + dt * C["taus"]
            h = dt * C["dmesh"]
            F, ALG, UDOT = self._pointwise(p, ts, Y, X, L, D)
            lead = z.shape[:-1]
            out = []
            if self.hermite_simpson:
                y0, y1, ym = Y[..., 0:-1:2, :], Y[..., 2::2, :], Y[..., 1::2, :]
                f0, f1, fm = F[..., 0:-1:2, :], F[..., 2::2, :], F[..., 1::2, :]
                hcol = h.unsqueeze(-1)
                hermite = ym - 0.5 * (y0 + y1) - hcol / 8.0 * (f0 - f1)
                simpson = y1 - y0 - hcol / 6.0 * (f0 + 4.0 * fm + f1)
                out.append(hermite.reshape(lead + (-1,)))
                out.append(simpson.reshape(lead + (-1,)))
                if self.nx and self.opt.interpolate_control_midpoints:
                    xm = X[..., 1::2, :] - 0.5 * (X[..., 0:-1:2, :] +
                                                  X[..., 2::2, :])
                    out.append(xm.reshape(lead + (-1,)))
            else:
                y0, y1 = Y[..., :-1, :], Y[..., 1:, :]
                f0, f1 = F[..., :-1, :], F[..., 1:, :]
                trap = y1 - y0 - 0.5 * h.unsqueeze(-1) * (f0 + f1)
                out.append(trap.reshape(lead + (-1,)))
            if ALG.shape[-1]:
                out.append(ALG.reshape(lead + (-1,)))
            if self.ec_goals:
                initial, final = self._endpoints(ts, Y, X, L, D)
                spos = 0
                for gi, g in enumerate(self.ec_goals):
                    vals = g.values(rep, initial, final, p)
                    if gi in self.ec_slack_specs:
                        k = vals.shape[-1]
                        out.append(vals - ecs[..., spos:spos + k])
                        spos += k
                    else:
                        out.append(vals - g.constraint_bounds[0])
            return torch.cat(out, -1)

        return constraints

    # ------------------------------------------------------------ objective
    def objective_fn(self, device="cuda", dtype=torch.float64):
        """``f(z)``: weighted cost goals plus the optional implicit-
        derivative penalties."""
        rep = self.rep
        C = self._constants(device, dtype)
        p = C["p"]
        opt = self.opt

        def objective(z):
            t0, tf, Y, X, L, D, Gm, pcs, ecs, theta = self.unpack(z)
            dt = (tf - t0).unsqueeze(-1)
            ts = t0.unsqueeze(-1) + dt * C["taus"]
            w = dt * C["quad_w"]
            initial, final = self._endpoints(ts, Y, X, L, D)
            total = torch.zeros_like(t0)
            for g in self.cost_goals:
                integrand = g.integrand(rep, ts, Y, X, L, p)
                S = (w * integrand).sum(-1)
                total = total + g.weight * g.value(rep, initial, final, S, p)
            if opt.minimize_implicit_multibody_accelerations and \
                    self.implicit_mb:
                a2 = (D[..., :self.nq] ** 2).sum(-1)
                total = total + opt.implicit_multibody_accelerations_weight * \
                    (w * a2).sum(-1)
            if opt.minimize_implicit_auxiliary_derivatives and self.n_zeta:
                zoff = self.nq if self.implicit_mb else 0
                d2 = (D[..., zoff:] ** 2).sum(-1)
                total = total + opt.implicit_auxiliary_derivatives_weight * \
                    (w * d2).sum(-1)
            return total

        return objective

    # ------------------------------------------------------------ diagnostics
    def constraint_group_info(self):
        """(name, size) per constraint block, in assembly order."""
        groups = []
        if self.hermite_simpson:
            groups.append(("hermite_defect", self.n_int * self.ny))
            groups.append(("simpson_defect", self.n_int * self.ny))
            if self.nx and self.opt.interpolate_control_midpoints:
                groups.append(("control_midpoint", self.n_int * self.nx))
        else:
            groups.append(("trapezoidal_defect", self.n_int * self.ny))
        n_alg = (self.nq if self.implicit_mb else 0) + self.n_zeta
        if n_alg:
            groups.append(("dae_residual", self.G * n_alg))
        for g in self.ec_goals:
            groups.append((f"endpoint:{g.name}", g.num_outputs))
        return groups

    # ------------------------------------------------------- KKT structure
    def kkt_structure(self):
        """Time-grouped block structure of the NLP (see
        ``solver.nlp.KKTStructure``): the variables and constraint rows of
        mesh interval i form block i; the times, endpoint-constraint rows
        and their slacks form the border. The same index lists as the JAX
        package's ``Transcription.kkt_structure``.

        None (dense path) when fewer than two intervals, or when a cost
        goal adds cross-block curvature (``Goal.hessian_block_local``).
        Raises on row groups the port does not assemble (path and
        kinematic constraints, prescribed motion), rather than building a
        wrong structure."""
        rep = self.rep
        if self.prescribed or self.nlam or rep.path_constraints or \
                self.n_gamma or self.n_pc_slack:
            raise NotImplementedError(
                "kkt_structure: prescribed motion, kinematic and path "
                "constraints are not ported yet (ROADMAP.md, queue 1)")
        N = self.n_int
        if N < 2:
            return None
        if not all(g.hessian_block_local() for g in self.cost_goals):
            return None
        o = self.offsets

        def var_ids(kind, g, per):
            start = o[kind][0] + g * per
            return list(range(start, start + per))

        def blk_of_grid(g):
            return min(g // 2 if self.hermite_simpson else g, N - 1)

        blocks_v = [[] for _ in range(N)]
        for g in range(self.G):
            b = blocks_v[blk_of_grid(g)]
            b += var_ids("states", g, self.ny)
            b += var_ids("controls", g, self.nx)
            b += var_ids("derivs", g, self.nderiv)
        border_v = [0, 1]
        border_v += list(range(*o["ec_slack"]))
        border_v += list(range(*o["params"]))

        # constraint rows, in constraints_fn's assembly order
        blocks_c = [[] for _ in range(N)]
        off = 0
        # interval-major defect rows: Hermite, Simpson, control midpoints
        # (or the trapezoidal defect)
        defects = [self.ny]
        if self.hermite_simpson:
            defects.append(self.ny)
            if self.nx and self.opt.interpolate_control_midpoints:
                defects.append(self.nx)
        for size in defects:
            for i in range(N):
                blocks_c[i] += list(range(off, off + size))
                off += size
        n_alg = (self.nq if self.implicit_mb else 0) + self.n_zeta
        if n_alg:  # grid-major DAE residual rows
            for g in range(self.G):
                blocks_c[blk_of_grid(g)] += list(range(off, off + n_alg))
                off += n_alg
        n_ec = sum(goal.num_outputs for goal in self.ec_goals)
        border_c = list(range(off, off + n_ec))
        return KKTStructure(var_blocks=blocks_v, con_blocks=blocks_c,
                            border_vars=np.asarray(border_v, np.int64),
                            border_cons=np.asarray(border_c, np.int64))

    # ---------------------------------------------------------------- NLP
    def make_nlp(self, device="cuda", dtype=torch.float64) -> NLP:
        """The NLP with its functions' constants on ``device`` and, where
        the problem has one, its KKT block structure."""
        lb, ub = self.bounds()
        m = sum(size for _, size in self.constraint_group_info())
        return NLP(n=self.n, m=m,
                   objective=self.objective_fn(device, dtype),
                   constraints=self.constraints_fn(device, dtype),
                   lb=lb, ub=ub, structure=self.kkt_structure())

    # --------------------------------------------------------------- guess
    def initial_guess(self, dtype=np.float64):
        """Bounds-midpoint guess: midpoint where both bounds are finite,
        else the finite bound, else zero (numpy)."""
        lb, ub = self.bounds()
        with np.errstate(invalid="ignore"):  # inf + -inf on unbounded vars
            mid = np.where(np.isfinite(lb) & np.isfinite(ub),
                           0.5 * (lb + ub),
                           np.where(np.isfinite(lb), lb,
                                    np.where(np.isfinite(ub), ub, 0.0)))
        return mid.astype(dtype)
