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
With optimizable parameters the model's parameter dict differs per
decision vector, so the functions then ``torch.func.vmap`` over the
leading dimensions and each evaluation sees one vector (the JAX package's
per-lane semantics).
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
        self.prescribed = model.prescribed
        # prescribed kinematics, a fixed time window and no parameters:
        # every kinematic quantity of the DAE is a constant of the grid,
        # folded at build time (JAX transcription.py:81-93); a switch, so
        # that a test can compare the folded and the general path
        self.fold_prescribed = bool(
            model.prescribed and not rep.parameters and
            rep.t0_bounds[0] == rep.t0_bounds[1] and
            rep.tf_bounds[0] == rep.tf_bounds[1])
        self._presc_cache = {}
        # prescribed: no multibody states and no acceleration variables;
        # the force balance is an algebraic row of its own
        self.implicit_mb = (options.multibody_dynamics_mode == "implicit"
                            and not self.prescribed)
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
        # velocity-correction slacks only exist for HS + constraint
        # derivatives, and not with prescribed kinematics (JAX
        # transcription.py:118-120)
        self.n_gamma = (self.nlam if (self.hermite_simpson and self.nlam and
                                      options.enforce_constraint_derivatives
                                      and not self.prescribed)
                        else 0)

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

        # a slack per two-sided path-constraint component and mesh point
        # (JAX transcription.py:137-144)
        self.n_pc_points = len(self.mesh_idx)
        self.pc_slack_specs = [
            (pi, k) for pi, pc in enumerate(rep.path_constraints)
            for k in range(len(pc.lower)) if pc.lower[k] != pc.upper[k]]
        self.n_pc_slack = len(self.pc_slack_specs) * self.n_pc_points

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

        if self.nlam:
            lb[o["multipliers"][0]:o["multipliers"][1]] = rep.lam_bounds[0]
            ub[o["multipliers"][0]:o["multipliers"][1]] = rep.lam_bounds[1]
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
        if self.n_gamma:
            lb[o["gamma"][0]:o["gamma"][1]] = \
                self.opt.velocity_correction_bounds[0]
            ub[o["gamma"][0]:o["gamma"][1]] = \
                self.opt.velocity_correction_bounds[1]
        # path-constraint slacks take the constraint's bounds
        # (JAX transcription.py:263-267)
        k = 0
        for (pi, comp) in self.pc_slack_specs:
            pc = rep.path_constraints[pi]
            for _ in range(self.n_pc_points):
                lb[o["pc_slack"][0] + k] = pc.lower[comp]
                ub[o["pc_slack"][0] + k] = pc.upper[comp]
                k += 1
        k = 0
        for gi in self.ec_slack_specs:
            g = self.ec_goals[gi]
            for _ in range(g.num_outputs):
                lb[o["ec_slack"][0] + k] = g.constraint_bounds[0]
                ub[o["ec_slack"][0] + k] = g.constraint_bounds[1]
                k += 1
        if self.npar:
            lb[o["params"][0]:o["params"][1]] = rep.param_lo
            ub[o["params"][0]:o["params"][1]] = rep.param_hi
        return lb, ub

    # ----------------------------------------------------------- dynamics
    def _pointwise(self, p, t, y, x, lam, d):
        """DAE on the grid: (ydot (..., G, ny), alg (..., G, n_alg), udot)
        where alg stacks the implicit multibody and implicit auxiliary
        residuals. With prescribed kinematics, ``y`` holds the auxiliary
        states alone, q, u and udot come from the position motion at the
        times ``t`` (..., G), and the multibody row is the force balance
        (JAX transcription.py:296-313)."""
        m = self.rep.model
        if self.prescribed:
            q, u, udot = m.position_motion(p, t)
            zeta = d[..., :self.n_zeta] if self.n_zeta else None
            alg = [m.multibody_implicit_residual(p, t, q, u, y, x, lam, udot)]
            if self.n_zeta:
                alg.append(m.implicit_aux_residuals(p, t, q, u, y, x, zeta))
            zdot = m.aux_dynamics(p, t, q, u, y, x, zeta)
            return zdot, torch.cat(alg, -1), udot
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
        """Per-device constants of the NLP functions (made once). A folded
        prescribed problem adds the force balance's constants at the grid
        times (``"presc"``), computed on ``device`` once per (device,
        dtype) and reused by every later call."""
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        out = {"p": self.rep.model.default_params(dev, dtype),
               "taus": t(self.taus), "dmesh": t(np.diff(self.mesh)),
               "quad_w": t(self.quad_w)}
        if self.fold_prescribed:
            out["presc"] = self._prescribed_constants(out["p"], dev, dtype)
        return out

    def _prescribed_constants(self, p, dev, dtype):
        """``Model.prescribed_point_constants`` at the grid times of the
        fixed window (JAX transcription.py:344-362), detached."""
        key = (dev, dtype)
        if key not in self._presc_cache:
            rep = self.rep
            t0, tf = float(rep.t0_bounds[0]), float(rep.tf_bounds[0])
            ts = torch.as_tensor(t0 + (tf - t0) * self.taus, dtype=dtype,
                                 device=dev)
            consts = rep.model.prescribed_point_constants(p, ts)
            self._presc_cache[key] = {k: v.detach()
                                      for k, v in consts.items()}
        return self._presc_cache[key]

    def _pointwise_folded(self, p, c, y, x, lam, d):
        """``_pointwise`` of a folded prescribed problem from the grid's
        constants ``c`` (JAX transcription.py:367-385): the muscle and
        actuator forces are all that is left to evaluate."""
        m = self.rep.model
        zeta = d[..., :self.n_zeta] if self.n_zeta else None
        pk = (c["lMT"], c["vMT"])
        alg = [m.prescribed_residual_cached(p, c, y, x, lam)]
        if self.n_zeta:
            alg.append(m.implicit_aux_residuals(p, c["t"], c["q"], c["u"], y,
                                                x, zeta, path_kin=pk))
        zdot = m.aux_dynamics(p, c["t"], c["q"], c["u"], y, x, zeta,
                              path_kin=pk)
        return zdot, torch.cat(alg, -1), c["udot"]

    @staticmethod
    def _endpoints(ts, Y, X, L, D):
        initial = (ts[..., 0], Y[..., 0, :], X[..., 0, :], L[..., 0, :],
                   D[..., 0, :])
        final = (ts[..., -1], Y[..., -1, :], X[..., -1, :], L[..., -1, :],
                 D[..., -1, :])
        return initial, final

    def _per_lane(self, fn):
        """``fn`` over any leading dims. Without parameters the functions
        broadcast; with parameters each decision vector carries its own
        model parameters, so ``fn`` is ``vmap``ped over one vector at a
        time."""
        if not self.npar:
            return fn

        def lanes(z):
            lead = z.shape[:-1]
            out = torch.func.vmap(fn)(z.reshape(-1, z.shape[-1]))
            return out.reshape(lead + out.shape[1:])

        return lanes

    def _at_mesh(self, a):
        """The mesh points of a grid-major (..., G, k) tensor."""
        return a[..., ::2, :] if self.hermite_simpson else a

    def _kc_errors(self, p, q, u, udot):
        """phi, phidot = G u and phiddot = d/dt (G u) at the mesh points,
        each (..., P, nlam) (JAX transcription.py:323-334); without
        constraint derivatives only phi."""
        m = self.rep.model

        def phi(qq):
            return m.phi(p, qq)

        if not self.opt.enforce_constraint_derivatives:
            return [phi(q)]

        def phidot(qq, uu):
            return torch.func.jvp(phi, (qq,), (uu,))[1]

        phiddot = torch.func.jvp(phidot, (q, u), (u, udot))[1]
        return [phi(q), phidot(q, u), phiddot]

    # ---------------------------------------------------------- constraints
    def constraints_fn(self, device="cuda", dtype=torch.float64):
        """``c(z)``: in the JAX package's row order, the midpoint-manifold
        rows (Hermite-Simpson with kinematic constraints), the defects, the
        algebraic residuals, the kinematic-constraint errors, the path
        constraints and the endpoint-constraint rows."""
        rep = self.rep
        m = rep.model
        C = self._constants(device, dtype)
        nq = self.nq

        def constraints(z):
            t0, tf, Y, X, L, D, Gm, pcs, ecs, theta = self.unpack(z)
            p = rep.apply_parameters(theta, C["p"])
            dt = (tf - t0).unsqueeze(-1)
            ts = t0.unsqueeze(-1) + dt * C["taus"]
            h = dt * C["dmesh"]
            if "presc" in C:
                F, ALG, UDOT = self._pointwise_folded(p, C["presc"], Y, X, L,
                                                      D)
            else:
                F, ALG, UDOT = self._pointwise(p, ts, Y, X, L, D)
            lead = z.shape[:-1]

            def flat(a):
                return a.reshape(lead + (-1,))

            out = []
            if self.hermite_simpson:
                y0, y1, ym = Y[..., 0:-1:2, :], Y[..., 2::2, :], Y[..., 1::2, :]
                f0, f1, fm = F[..., 0:-1:2, :], F[..., 2::2, :], F[..., 1::2, :]
                hcol = h.unsqueeze(-1)
                hermite = ym - 0.5 * (y0 + y1) - hcol / 8.0 * (f0 - f1)
                if self.n_gamma:
                    # Posa velocity correction on the q rows, qbar =
                    # hermite(q) + G(qbar)^T gamma, with the corrected
                    # midpoint pinned to the manifold, phi(qbar) = 0
                    # (JAX transcription.py:407-420)
                    qmid = ym[..., :nq]
                    Gt_gamma = m.constraint_jacobian_T(p, qmid, Gm)
                    hermite = hermite - torch.cat(
                        [Gt_gamma, torch.zeros_like(hermite[..., nq:])], -1)
                    out.append(flat(m.phi(p, qmid)))
                simpson = y1 - y0 - hcol / 6.0 * (f0 + 4.0 * fm + f1)
                out.append(flat(hermite))
                out.append(flat(simpson))
                if self.nx and self.opt.interpolate_control_midpoints:
                    xm = X[..., 1::2, :] - 0.5 * (X[..., 0:-1:2, :] +
                                                  X[..., 2::2, :])
                    out.append(flat(xm))
            else:
                y0, y1 = Y[..., :-1, :], Y[..., 1:, :]
                f0, f1 = F[..., :-1, :], F[..., 1:, :]
                trap = y1 - y0 - 0.5 * h.unsqueeze(-1) * (f0 + f1)
                out.append(flat(trap))
            if ALG.shape[-1]:
                out.append(flat(ALG))
            if self.nlam and not self.prescribed:
                # kinematic-constraint errors at the mesh points (JAX
                # transcription.py:436-447); with prescribed kinematics
                # phi(q) is data, and the multipliers enter the force
                # balance alone
                Ym = self._at_mesh(Y)
                out += [flat(e) for e in self._kc_errors(
                    p, Ym[..., :nq], Ym[..., nq:2 * nq],
                    self._at_mesh(UDOT))]
            if rep.path_constraints:
                # path constraints at the mesh points, minus a slack when
                # two-sided (JAX transcription.py:449-465)
                P = self.n_pc_points
                tm = ts[..., ::2] if self.hermite_simpson else ts
                Ym, Xm, Lm = (self._at_mesh(a) for a in (Y, X, L))
                spos = 0
                for pc in rep.path_constraints:
                    vals = pc.fn(rep, tm, Ym, Xm, Lm, p)
                    if vals.dim() == tm.dim():
                        vals = vals.unsqueeze(-1)
                    vals = vals.expand(lead + (P, len(pc.lower)))
                    for k in range(len(pc.lower)):
                        col = vals[..., k]
                        if pc.lower[k] == pc.upper[k]:
                            out.append(col - pc.lower[k])
                        else:
                            out.append(col - pcs[..., spos * P:
                                                 (spos + 1) * P])
                            spos += 1
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

        return self._per_lane(constraints)

    # ------------------------------------------------------------ objective
    def _cost_terms(self, z, C):
        """The cost goals' weighted terms at ``z`` (..., n), in goal order,
        with the quadrature weights (..., G), the multipliers and the
        derivative variables, from the device constants ``C``."""
        rep = self.rep
        t0, tf, Y, X, L, D, _, _, _, theta = self.unpack(z)
        p = rep.apply_parameters(theta, C["p"])
        dt = (tf - t0).unsqueeze(-1)
        ts = t0.unsqueeze(-1) + dt * C["taus"]
        w = dt * C["quad_w"]
        initial, final = self._endpoints(ts, Y, X, L, D)
        terms = []
        for g in self.cost_goals:
            S = (w * g.integrand(rep, ts, Y, X, L, p)).sum(-1)
            terms.append(g.weight * g.value(rep, initial, final, S, p))
        return terms, w, L, D

    def objective_fn(self, device="cuda", dtype=torch.float64):
        """``f(z)``: weighted cost goals plus the optional multiplier and
        implicit-derivative penalties."""
        C = self._constants(device, dtype)
        opt = self.opt

        def objective(z):
            terms, w, L, D = self._cost_terms(z, C)
            total = torch.zeros_like(z[..., 0])
            for term in terms:
                total = total + term
            if opt.minimize_lagrange_multipliers and self.nlam:
                total = total + opt.lagrange_multiplier_weight * \
                    (w * (L * L).sum(-1)).sum(-1)
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

        return self._per_lane(objective)

    # ------------------------------------------------------------ diagnostics
    def constraint_group_info(self):
        """(name, size) per constraint block, in assembly order."""
        groups = []
        if self.hermite_simpson:
            if self.n_gamma:
                groups.append(("midpoint_manifold_phi",
                               self.n_int * self.nlam))
            groups.append(("hermite_defect", self.n_int * self.ny))
            groups.append(("simpson_defect", self.n_int * self.ny))
            if self.nx and self.opt.interpolate_control_midpoints:
                groups.append(("control_midpoint", self.n_int * self.nx))
        else:
            groups.append(("trapezoidal_defect", self.n_int * self.ny))
        n_alg = ((self.nq if self.implicit_mb or self.prescribed else 0) +
                 self.n_zeta)
        if n_alg:
            groups.append(("dae_residual", self.G * n_alg))
        if self.nlam and not self.prescribed:
            mult = 3 if self.opt.enforce_constraint_derivatives else 1
            groups.append(("kinematic_constraint",
                           len(self.mesh_idx) * self.nlam * mult))
        for pc in self.rep.path_constraints:
            groups.append((f"path:{pc.name}",
                           self.n_pc_points * len(pc.lower)))
        for g in self.ec_goals:
            groups.append((f"endpoint:{g.name}", g.num_outputs))
        return groups

    def objective_breakdown(self, z, device="cuda", dtype=torch.float64):
        """{goal name: weighted cost term} of the cost goals at the flat
        iterate ``z`` (n,), evaluated on ``device`` (the card unless the
        caller asks for the CPU; printObjectiveBreakdown, JAX
        ``transcription.py:566``). The multiplier and implicit-derivative
        penalties are not goals and are left out."""
        dev = resolve_device(device)
        terms = self._cost_terms(torch.as_tensor(
            np.asarray(z), dtype=dtype, device=dev),
            self._constants(dev, dtype))[0]
        return {g.name: float(v) for g, v in zip(self.cost_goals, terms)}

    def constraint_report(self, z, device="cuda", dtype=torch.float64):
        """{constraint group: max |c|} at the flat iterate ``z`` (n,), the
        raw residuals of ``constraints_fn`` on ``device`` (the card unless
        the caller asks for the CPU; JAX ``transcription.py:591``), by the
        groups of :meth:`constraint_group_info`."""
        dev = resolve_device(device)
        c = self.constraints_fn(dev, dtype)(torch.as_tensor(
            np.asarray(z), dtype=dtype, device=dev)).cpu().numpy()
        report = {}
        off = 0
        for name, size in self.constraint_group_info():
            seg = c[off:off + size]
            report[name] = float(np.max(np.abs(seg))) if size else 0.0
            off += size
        assert off == len(c), (off, len(c), "constraint group info out of "
                               "sync with constraints_fn")
        return report

    # ------------------------------------------------------- KKT structure
    def kkt_structure(self):
        """Time-grouped block structure of the NLP (see
        ``solver.nlp.KKTStructure``): the variables and constraint rows of
        mesh interval i form block i; the times, parameters,
        endpoint-constraint rows and their slacks form the border. The
        same index lists as the JAX package's
        ``Transcription.kkt_structure`` (transcription.py:617-706).

        None (dense path) when fewer than two intervals, or when a cost
        goal adds cross-block curvature (``Goal.hessian_block_local``)."""
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
            b += var_ids("multipliers", g, self.nlam)
            b += var_ids("derivs", g, self.nderiv)
        for i in range(N):  # velocity corrections
            blocks_v[i] += var_ids("gamma", i, self.n_gamma)
        npts = self.n_pc_points
        for spos in range(len(self.pc_slack_specs)):  # path slacks
            for j in range(npts):
                blocks_v[min(j, N - 1)].append(
                    o["pc_slack"][0] + spos * npts + j)
        border_v = [0, 1]
        border_v += list(range(*o["ec_slack"]))
        border_v += list(range(*o["params"]))

        # constraint rows, in constraints_fn's assembly order
        blocks_c = [[] for _ in range(N)]
        off = 0

        def rows(per, count, block_of):
            nonlocal off
            for j in range(count):
                blocks_c[block_of(j)] += list(range(off, off + per))
                off += per

        def interval_major(per):
            rows(per, N, lambda i: i)

        def grid_major(per):
            rows(per, self.G, blk_of_grid)

        def mesh_major(per):
            rows(per, len(self.mesh_idx), lambda j: min(j, N - 1))

        if self.hermite_simpson:
            if self.n_gamma:
                interval_major(self.nlam)  # midpoint manifold phi
            interval_major(self.ny)  # Hermite
            interval_major(self.ny)  # Simpson
            if self.nx and self.opt.interpolate_control_midpoints:
                interval_major(self.nx)
        else:
            interval_major(self.ny)  # trapezoidal defect
        n_alg = ((self.nq if self.implicit_mb or self.prescribed else 0) +
                 self.n_zeta)
        if n_alg:  # the force balance's nq rows when prescribed
            grid_major(n_alg)
        if self.nlam and not self.prescribed:
            mult = 3 if self.opt.enforce_constraint_derivatives else 1
            for _ in range(mult):  # phi, phidot, phiddot
                mesh_major(self.nlam)
        for pc in self.rep.path_constraints:
            for _ in range(len(pc.lower)):
                mesh_major(1)
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
    def derivative_names(self):
        """Names of the derivative columns, in the layout's order: with
        implicit multibody dynamics ``<coordinate>/accel`` per coordinate,
        then ``/forceset/<muscle>/implicitderiv_normalized_tendon_force``
        per implicit tendon (the reference's names, JAX
        ``ocp/study.py:254-263``)."""
        model = self.rep.model
        names = ([f"{c}/accel" for c in model.coordinate_paths()]
                 if self.implicit_mb else [])
        return names + [f"/forceset/{m}/implicitderiv_normalized_tendon_force"
                        for m in model._implicit_aux]

    def guess_from_trajectory(self, traj, dtype=np.float64):
        """Flat numpy iterate from a ``Trajectory``/``Solution`` (the
        reference's guess-file warm start; JAX
        ``transcription.py:724``): the bounds-midpoint guess with the
        trajectory's time window, and its states, controls, multipliers
        and derivative columns, resampled onto this grid
        (``Trajectory.resample``), copied in by name."""
        z = np.array(self.initial_guess(dtype=dtype))
        t0, tf = traj.initial_time, traj.final_time
        z[0], z[1] = t0, tf
        res = traj.resample(t0 + (tf - t0) * np.asarray(self.taus))
        o = self.offsets
        Y = z[o["states"][0]:o["states"][1]].reshape(self.G, self.ny)
        for i, n in enumerate(self.rep.state_names):
            if n in res.state_names:
                Y[:, i] = res.state(n)
        X = z[o["controls"][0]:o["controls"][1]].reshape(self.G, self.nx)
        for i, n in enumerate(self.rep.control_names):
            if n in res.control_names:
                X[:, i] = res.control(n)
        if self.nlam and res.multipliers is not None and \
                res.multipliers.shape[1] == self.nlam:
            z[o["multipliers"][0]:o["multipliers"][1]] = \
                res.multipliers.ravel()
        if self.nderiv and res.derivatives is not None:
            D = z[o["derivs"][0]:o["derivs"][1]].reshape(self.G, self.nderiv)
            names = list(res.derivative_names)
            for i, n in enumerate(self.derivative_names()):
                if n in names:
                    D[:, i] = res.derivatives[:, names.index(n)]
        return z

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
