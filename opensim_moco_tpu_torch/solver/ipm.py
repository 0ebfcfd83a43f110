"""Batched primal-dual interior-point NLP solver in PyTorch.

Counterpart of ``opensim_moco_tpu.solver.ipm``: the same Waechter-Biegler
filter line-search algorithm with the same options, safeguards and
defaults (monotone barrier schedule with the mu watchdog and rescues,
fraction-to-boundary rule, kappa-Sigma dual safeguard, second-order
correction, feasibility fallback, inertia-free regularization, fixed
variable elimination, gradient-based scaling, best-iterate and
acceptable-level exits).

The JAX package writes the solver for one problem and ``vmap``s it. Here
the solver is batched from the start: every carry field has a leading
lane dimension B and every lane computes what it would compute alone.
``vmap``'s implicit semantics become explicit code:

* a ``lax.while_loop`` under ``vmap`` keeps running while any lane's
  condition holds and discards the new state of lanes whose condition is
  false: :func:`body_fn` returns those lanes unchanged (lanes that have
  converged or reached ``max_iter`` stay frozen, field by field);
* a ``lax.cond`` under ``vmap`` evaluates both branches and selects: the
  backtracking and feasibility-fallback candidates are evaluated for every
  lane and masked;
* the regularization ``while_loop`` runs while any lane still needs a
  trial and applies a new trial only to those lanes.

Derivatives and KKT, as in the JAX package, with two levers:

* compressed block derivatives (``solver/structured.py``): whenever the NLP
  carries a KKT structure and ``kkt != "dense"``, J and the Lagrangian
  Hessian come from ``2·nv + kv`` and ``nv + kv`` seeded tangents instead
  of ``n``; otherwise ``torch.func.jacfwd`` and ``jacfwd(grad(L))`` under
  ``vmap`` over lanes;
* the bordered block-tridiagonal ("btb") factorization: under
  ``kkt="structured"``, or ``"auto"`` with n+m >= ``kkt_structured_min_dim``,
  each regularization trial factors the KKT blocks with K1
  (``ops/btb.py``: the CUDA kernel on the card, its plain version on the
  CPU); otherwise one pivoted LU of the full (n+m) KKT
  (``torch.linalg.lu_factor_ex``), or, with
  ``dense_factorization="chol-schur"``, Cholesky of H + Sigma + delta_w I
  and of the Schur complement J (H + Sigma + delta_w I)^-1 J^T +
  delta_c I. Each reports a singular or indefinite factor through NaN/inf
  in its own lane's solve rather than by raising.

Host synchronisation: the solve loop reads one flag per iteration (are all
lanes done?) and the regularization loop one per trial (does any lane
need another?). Nothing else in an iteration reads tensor values on the
host.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import grad, jacfwd, jvp, vjp, vmap

from ..config import full_precision, resolve_device
from ..ops import btb as k1
from .kkt import CompiledStructure
from .nlp import NLP
from .structured import (BlockDerivatives, BTBFac, assemble_kkt_blocks,
                         block_H_diag, block_H_matvec, dense_H_from_blocks,
                         dense_J_from_blocks, pack_rhs, unpack_sol)
from .structured import cholesky_factor as _cholesky
from .structured import lu_factor as _lu_factor

FILTER_SIZE = 64


@dataclasses.dataclass(frozen=True)
class IPMOptions:
    """The JAX package's ``IPMOptions``: every field, same defaults (see
    ``opensim_moco_tpu/solver/ipm.py`` for the rationale of each)."""
    tol: float = 1e-6
    max_iter: int = 500
    mu_init: float = 1e-1
    mu_min_factor: float = 1.0 / 11.0  # mu_min = tol * factor
    kappa_eps: float = 10.0
    mu_force_iter: int = 10
    kappa_mu: float = 0.2
    theta_mu: float = 1.5
    tau_min: float = 0.99
    kappa_sigma: float = 1e10
    bound_relax: float = 1e-8
    bound_push: float = 1e-2
    delta_w_init: float = 1e-8
    delta_w_max: float = 1e10
    max_ls: int = 12  # candidate-parallel line-search trial count
    max_reg: int = 12  # regularization retries
    acceptable_tol_factor: float = 100.0
    acceptable_iter: int = 15
    max_rescues: int = 4
    hessian_approximation: str = "exact"  # | "objective-only"
    gamma_theta: float = 1e-5
    gamma_phi: float = 1e-5
    s_theta: float = 1.1
    s_phi: float = 2.3
    delta_switch: float = 1.0
    eta_phi: float = 1e-8
    kkt: str = "auto"  # | "dense" | "structured"
    kkt_structured_min_dim: int = 1200
    dense_factorization: str = "lu"  # | "chol-schur"
    init_multipliers: str = "least-squares"  # | "zero"
    kkt_refine_iters: int = 0


class IPMResult(NamedTuple):
    z: torch.Tensor  # (B, n_full)
    nu: torch.Tensor  # (B, m)
    f: torch.Tensor  # (B,)
    kkt_error: torch.Tensor  # (B,)
    iterations: torch.Tensor  # (B,) int32
    converged: torch.Tensor  # (B,) bool


class Carry(NamedTuple):
    z: torch.Tensor
    nu: torch.Tensor
    wL: torch.Tensor
    wU: torch.Tensor
    mu: torch.Tensor
    it: torch.Tensor
    converged: torch.Tensor
    kkt: torch.Tensor
    alpha_last: torch.Tensor
    delta_last: torch.Tensor
    filter_theta: torch.Tensor  # (B, FILTER_SIZE)
    filter_phi: torch.Tensor  # (B, FILTER_SIZE)
    filter_count: torch.Tensor
    theta_scale: torch.Tensor  # max(1, theta(z0)) for theta_min/theta_max
    best_z: torch.Tensor  # best-KKT iterate seen so far
    best_nu: torch.Tensor
    best_kkt: torch.Tensor
    acceptable_count: torch.Tensor
    rescue_count: torch.Tensor
    stall_count: torch.Tensor  # consecutive fully-rejected iterations
    mu_wait: torch.Tensor  # accepted steps since the last mu decrease


def _inf_norm(x):
    """Max |x| over the last dim (0 for an empty last dim)."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    return x.abs().amax(-1)


def _dot(a, b):
    return (a * b).sum(-1)


def _where(cond, a, b):
    """``torch.where`` with ``cond`` broadcast from the left (lane masks
    against (B, ...) fields)."""
    while cond.dim() < max(torch.as_tensor(a).dim(),
                           torch.as_tensor(b).dim()):
        cond = cond.unsqueeze(-1)
    return torch.where(cond, a, b)


def _validate(opt: IPMOptions):
    if opt.kkt not in ("auto", "dense", "structured"):
        raise ValueError(f"kkt must be auto|dense|structured, got "
                         f"{opt.kkt!r}")
    if opt.dense_factorization not in ("lu", "chol-schur"):
        raise ValueError(f"dense_factorization must be lu|chol-schur, got "
                         f"{opt.dense_factorization!r}")


def make_kernel(nlp: NLP, options: IPMOptions = IPMOptions(), scale_z0=None,
                *, device="cuda", dtype=torch.float64):
    """Build batched ``(init_fn, body_fn, cond_fn, finalize_fn)``.

    ``init_fn(Z0)`` takes (B, n) starting points and returns a
    :class:`Carry`; ``body_fn`` advances every live lane by one iteration;
    ``cond_fn`` says which lanes are live; ``finalize_fn`` gives the
    :class:`IPMResult`. ``scale_z0``: reference point (n,) for IPOPT-style
    gradient-based scaling of the objective and each constraint row.
    ``device``: the card unless the caller asks for the CPU."""
    opt = options
    _validate(opt)
    dev = resolve_device(device)

    def const(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

    st = nlp.structure
    cs_full = None
    if nlp.m and st is not None:
        cs_full = CompiledStructure(st.var_blocks, st.con_blocks,
                                    st.border_vars, st.border_cons,
                                    nlp.n, nlp.m)

    f_unscale = 1.0
    f_base, c_base = nlp.objective, nlp.constraints
    if scale_z0 is not None:
        z0s = const(scale_z0)
        g0 = grad(f_base)(z0s).cpu().numpy()
        gmax = 100.0
        f_scale = float(min(1.0, gmax / max(np.max(np.abs(g0)), 1e-8)))
        f_unscale = 1.0 / f_scale
        if cs_full is not None:
            # compressed 2-coloring pass: O(nv) tangents, not O(n)
            row_norms = BlockDerivatives(cs_full, c_base, dev,
                                         dtype).jac_row_inf_norms(z0s)
        else:
            row_norms = jacfwd(c_base)(z0s).abs().amax(-1).cpu().numpy()
        c_scale = const(np.minimum(1.0, gmax / np.maximum(row_norms, 1e-8)))
        f_scaled = lambda z: f_scale * f_base(z)  # noqa: E731
        c_scaled = lambda z: c_scale * c_base(z)  # noqa: E731
    else:
        f_scaled, c_scaled = f_base, c_base

    lb_np = np.asarray(nlp.lb, dtype=np.float64)
    ub_np = np.asarray(nlp.ub, dtype=np.float64)
    fixed_mask = np.isfinite(lb_np) & (lb_np == ub_np)
    free_idx = np.nonzero(~fixed_mask)[0]
    fixed_idx = np.nonzero(fixed_mask)[0]
    has_fixed = bool(fixed_idx.size)
    if has_fixed:
        free_t = torch.as_tensor(free_idx, device=dev)
        fixed_vals = const(lb_np[fixed_idx])
        # full[i] = cat([free, fixed])[perm[i]]
        perm = torch.as_tensor(np.argsort(np.concatenate([free_idx,
                                                          fixed_idx])),
                               device=dev)

        def to_full(zr):
            pinned = fixed_vals.expand(zr.shape[:-1] + fixed_vals.shape)
            return torch.cat([zr, pinned], -1).index_select(-1, perm)

        f_fn = lambda zr: f_scaled(to_full(zr))  # noqa: E731
        c_fn = lambda zr: c_scaled(to_full(zr))  # noqa: E731
    else:
        to_full = lambda zr: zr  # noqa: E731
        f_fn, c_fn = f_scaled, c_scaled
    lb_np, ub_np = lb_np[free_idx], ub_np[free_idx]
    n, m = len(free_idx), nlp.m

    def lagrangian(z, nu):
        return f_fn(z) + _dot(c_fn(z), nu)

    grad_f = vmap(grad(f_fn))
    jac_c = vmap(jacfwd(c_fn))
    if opt.hessian_approximation == "objective-only":
        # drop constraint curvature: the Hessian is the objective's
        hess_L = vmap(lambda z, nu: jacfwd(grad(f_fn))(z))

        def lag_grad(z, nu):
            return grad(lambda zz: f_fn(zz).sum())(z)
    else:
        hess_L = vmap(jacfwd(grad(lagrangian)))

        def lag_grad(z, nu):
            """Per-lane gradient of the Lagrangian, (..., n) (the lanes
            are independent, so the gradient of their sum)."""
            return grad(lambda zz: lagrangian(zz, nu).sum())(z)

    # ---- structured path, two levers (as in the JAX package):
    # * compressed block derivatives whenever a KKT structure exists and
    #   kkt != "dense": O(nv) tangents instead of O(n);
    # * the btb factorization (K1) under kkt="structured", or "auto" once
    #   n+m reaches kkt_structured_min_dim.
    # kkt="dense" is a full opt-out: dense autodiff, one dense LU.
    bd = ix = None
    if cs_full is not None and opt.kkt != "dense":
        cs = cs_full.remap_free(free_idx) if has_fixed else cs_full
        bd = BlockDerivatives(cs, c_fn, dev, dtype)
        ix = bd.ix
    use_btb = bd is not None and (
        opt.kkt == "structured" or
        (opt.kkt == "auto" and n + m >= opt.kkt_structured_min_dim))

    has_l_np = np.isfinite(lb_np)
    has_u_np = np.isfinite(ub_np)
    # IPOPT-style bound relaxation keeps a nonempty strict interior
    lb_r = np.where(has_l_np, lb_np - opt.bound_relax *
                    np.maximum(1.0, np.abs(lb_np)), lb_np)
    ub_r = np.where(has_u_np, ub_np + opt.bound_relax *
                    np.maximum(1.0, np.abs(ub_np)), ub_np)
    l_t, u_t = const(lb_r), const(ub_r)
    has_l = torch.as_tensor(has_l_np, device=dev)
    has_u = torch.as_tensor(has_u_np, device=dev)
    eye_n = torch.eye(n, dtype=dtype, device=dev)
    eye_m = torch.eye(m, dtype=dtype, device=dev)
    slots = torch.arange(FILTER_SIZE, device=dev)
    halves = const(0.5 ** np.arange(1, opt.max_ls + 1))
    mu_init = opt.mu_init
    acc_tol = opt.acceptable_tol_factor * opt.tol

    def _dl_du(z):
        dl = torch.where(has_l, z - l_t, 1.0)
        du = torch.where(has_u, u_t - z, 1.0)
        return dl, du

    def _theta(c):
        """Constraint violation ||c||_1 (inf for non-finite)."""
        v = c.abs().sum(-1)
        return torch.where(torch.isfinite(v), v, torch.inf)

    def _phi(z, mu):
        """Barrier objective (inf outside the interior); ``mu`` broadcasts
        against z's leading dims."""
        dl, du = _dl_du(z)
        interior = (dl > 0).all(-1) & (du > 0).all(-1)
        logs = (torch.where(has_l, torch.log(torch.where(dl > 0, dl, 1.0)),
                            0.0).sum(-1) +
                torch.where(has_u, torch.log(torch.where(du > 0, du, 1.0)),
                            0.0).sum(-1))
        val = f_fn(z) - mu * logs
        bad = ~interior | ~torch.isfinite(val)
        return torch.where(bad, torch.inf, val)

    def _fresh_filter(theta_scale):
        """Filter holding only the theta_max cap (reset on each mu change)."""
        first = slots == 0
        ftheta = torch.where(first, 1e4 * theta_scale[:, None], torch.inf)
        fphi = torch.where(first, -torch.inf,
                           torch.full_like(ftheta, torch.inf))
        fcount = torch.ones_like(theta_scale, dtype=torch.int32)
        return ftheta, fphi, fcount

    def _lu_solve(K, rhs):
        LU, piv = _lu_factor(K)
        return torch.linalg.lu_solve(LU, piv, rhs.unsqueeze(-1)).squeeze(-1)

    def _ls_multipliers_btb(z, r1):
        """Least-squares multipliers from the btb system with H = I:
        [[I, J^T], [J, -1e-8 I]] [., nu] = [r1, 0]."""
        B = z.shape[0]
        mv = ix.mv
        eye_v = torch.eye(ix.nv, dtype=dtype, device=dev)
        hb0 = dict(
            Hvv=(eye_v * (mv[:, :, None] * mv[:, None, :])).expand(
                B, ix.N, ix.nv, ix.nv),
            Hvb=z.new_zeros((B, ix.N, ix.nv, ix.kv)),
            Hbb=torch.eye(ix.kv, dtype=dtype, device=dev).expand(
                B, ix.kv, ix.kv))
        fac0 = k1.btb_factor(*assemble_kkt_blocks(
            hb0, bd.jac_blocks(z), z.new_zeros((B, n)), z.new_zeros(B),
            z.new_full((B,), 1e-8), ix))
        x0, w0 = k1.btb_solve(fac0, *pack_rhs(r1, z.new_zeros((B, m)), ix))
        return unpack_sol(x0, w0, ix)[1]

    def init_fn(Z0_full) -> Carry:
        Z0_full = torch.as_tensor(Z0_full, dtype=dtype, device=dev)
        z0 = Z0_full.index_select(-1, free_t) if has_fixed else Z0_full
        B = z0.shape[0]
        both = has_l & has_u
        width = torch.where(both, u_t - l_t, torch.inf)
        pl = torch.minimum(opt.bound_push * torch.clamp(l_t.abs(), min=1.0),
                           0.25 * width)
        pu = torch.minimum(opt.bound_push * torch.clamp(u_t.abs(), min=1.0),
                           0.25 * width)
        z = torch.clamp(z0, min=torch.where(has_l, l_t + pl, -torch.inf),
                        max=torch.where(has_u, u_t - pu, torch.inf))
        mu0 = torch.full((B,), mu_init, dtype=dtype, device=dev)
        dl, du = _dl_du(z)
        wL = torch.where(has_l, mu0[:, None] / dl, 0.0)
        wU = torch.where(has_u, mu0[:, None] / du, 0.0)
        theta_scale = torch.clamp(_theta(c_fn(z)), min=1.0)
        ftheta, fphi, fcount = _fresh_filter(theta_scale)
        nu0 = z.new_zeros((B, m))
        if m and opt.init_multipliers == "least-squares":
            g0 = grad_f(z)
            r1 = -(g0 - torch.where(has_l, wL, 0.0) +
                   torch.where(has_u, wU, 0.0))
            if bd is not None:
                nu0 = _ls_multipliers_btb(z, r1)
            else:
                J0 = jac_c(z)
                K0 = torch.cat([
                    torch.cat([eye_n.expand(B, n, n),
                               J0.transpose(-1, -2)], -1),
                    torch.cat([J0, (-1e-8 * eye_m).expand(B, m, m)], -1)],
                    -2)
                nu0 = _lu_solve(K0, torch.cat([r1, z.new_zeros((B, m))],
                                              -1))[:, n:]
            # degenerate-Jacobian guard: discard a huge least-squares dual
            nu0 = torch.where(torch.isfinite(nu0), nu0, 0.0)
            nu0 = _where(_inf_norm(nu0) <= 1e3, nu0, torch.zeros_like(nu0))
        izero = torch.zeros((B,), dtype=torch.int32, device=dev)
        return Carry(z=z, nu=nu0, wL=wL, wU=wU, mu=mu0, it=izero,
                     converged=torch.zeros((B,), dtype=torch.bool,
                                           device=dev),
                     kkt=torch.full_like(mu0, torch.inf),
                     alpha_last=torch.ones_like(mu0),
                     delta_last=torch.zeros_like(mu0),
                     filter_theta=ftheta, filter_phi=fphi,
                     filter_count=fcount, theta_scale=theta_scale,
                     best_z=z, best_nu=nu0,
                     best_kkt=torch.full_like(mu0, torch.inf),
                     acceptable_count=izero, rescue_count=izero,
                     stall_count=izero, mu_wait=izero)

    def _max_step(val, dval, active, tau):
        """Fraction-to-boundary step (B,) for a direction (B, n)."""
        safe = torch.where(active & (dval < 0),
                           -tau[:, None] * val /
                           torch.where(dval < 0, dval, -1.0), torch.inf)
        if safe.shape[-1] == 0:
            return torch.ones_like(tau)
        return torch.clamp(safe.amin(-1), max=1.0)

    def _step(carry: Carry) -> Carry:
        z, nu, wL, wU, mu = carry.z, carry.nu, carry.wL, carry.wU, carry.mu
        B = z.shape[0]
        mu_min = opt.tol * opt.mu_min_factor

        g = grad_f(z)
        cz = c_fn(z)
        dl, du = _dl_du(z)
        # clamp the slacks used in divisions so duals stay finite
        dls = torch.clamp(dl, min=1e-20)
        dus = torch.clamp(du, min=1e-20)
        SigL = torch.where(has_l, wL / dls, 0.0)
        SigU = torch.where(has_u, wU / dus, 0.0)
        Sig = SigL + SigU

        if bd is not None:
            jb = bd.jac_blocks(z)
            hb = bd.hess_blocks(lag_grad, z, nu)
            Jt_nu = vjp(c_fn, z)[1](nu)[0]
            h_diag = block_H_diag(hb, ix)
            if not use_btb:
                J = dense_J_from_blocks(jb, ix)
                W = dense_H_from_blocks(hb, ix)
        else:
            J = jac_c(z)
            W = hess_L(z, nu)
            Jt_nu = (J.transpose(-1, -2) @ nu.unsqueeze(-1)).squeeze(-1)
            h_diag = torch.diagonal(W, dim1=-2, dim2=-1)
        rd = g + Jt_nu - torch.where(has_l, wL, 0.0) + \
            torch.where(has_u, wU, 0.0)
        smax = 100.0
        ssum = nu.abs().sum(-1) + wL.abs().sum(-1) + wU.abs().sum(-1)
        sd = torch.clamp(ssum / (m + 2 * n), min=smax) / smax
        sc = torch.clamp((wL.abs().sum(-1) + wU.abs().sum(-1)) /
                         max(1, 2 * n), min=smax) / smax

        def err_parts(mu_val):
            compL = torch.where(has_l, dl * wL - mu_val[:, None], 0.0)
            compU = torch.where(has_u, du * wU - mu_val[:, None], 0.0)
            dual = _inf_norm(rd) / sd
            primal = _inf_norm(cz)
            comp = torch.maximum(_inf_norm(compL), _inf_norm(compU)) / sc
            return dual, primal, comp

        def err(mu_val):
            dual, primal, comp = err_parts(mu_val)
            return torch.maximum(dual, torch.maximum(primal, comp))

        zero_b = torch.zeros_like(mu)
        e0 = err(zero_b)
        # best-iterate + acceptable-level bookkeeping
        is_best = e0 < carry.best_kkt
        best_z = _where(is_best, z, carry.best_z)
        best_nu = _where(is_best, nu, carry.best_nu)
        best_kkt = torch.where(is_best, e0, carry.best_kkt)
        acceptable_count = torch.where(e0 <= acc_tol,
                                       carry.acceptable_count + 1, 0)
        converged = (e0 <= opt.tol) | \
            ((acceptable_count >= opt.acceptable_iter) & (best_kkt <= acc_tol))
        e_mu = err(mu)
        # Fiacco-McCormick decrease gated on an accepted last step, plus
        # the mu_force_iter watchdog
        force_mu = carry.mu_wait >= opt.mu_force_iter
        mu_new = torch.where(
            ((e_mu <= opt.kappa_eps * mu) & (carry.alpha_last > 0)) |
            force_mu,
            torch.clamp(torch.minimum(opt.kappa_mu * mu, mu ** opt.theta_mu),
                        min=mu_min),
            mu)
        mu_changed = mu_new != mu
        ft0, fp0, fc0 = _fresh_filter(carry.theta_scale)
        ftheta = _where(mu_changed, ft0, carry.filter_theta)
        fphi = _where(mu_changed, fp0, carry.filter_phi)
        fcount = torch.where(mu_changed, fc0, carry.filter_count)

        mu_col = mu_new[:, None]
        rhs1 = -(g + Jt_nu) + torch.where(has_l, mu_col / dls, 0.0) - \
            torch.where(has_u, mu_col / dus, 0.0)
        rhs2 = -cz
        gphi = g - torch.where(has_l, mu_col / dls, 0.0) + \
            torch.where(has_u, mu_col / dus, 0.0)
        wscale = torch.clamp(_inf_norm(h_diag + Sig), min=1.0)
        delta_c = 1e-8 * wscale

        # factor once per regularization trial; the Newton step, the
        # second-order correction and the feasibility fallback share it
        if use_btb:
            def H_mv(v):
                return block_H_matvec(hb, ix, v) + Sig * v

            def kkt_factor(delta_w):
                return k1.btb_factor(*assemble_kkt_blocks(
                    hb, jb, Sig, delta_w, delta_c, ix))

            def kkt_solve(fac, r1, r2):
                x, w = k1.btb_solve(fac, *pack_rhs(r1, r2, ix))
                return unpack_sol(x, w, ix)
        elif opt.dense_factorization == "chol-schur":
            # pivot-free quasi-definite factorization (JAX
            # solver/ipm.py:607-647): Lh = chol(Hd), Y = Lh^-1 J^T,
            # Ls = chol(Y^T Y + delta_c I). An indefinite Hd gives a NaN
            # factor in its lane and the regularization loop escalates
            # delta there, like an IPOPT inertia correction.
            H = W + torch.diag_embed(Sig)
            tri = torch.linalg.solve_triangular

            def H_mv(v):
                return (H @ v.unsqueeze(-1)).squeeze(-1)

            def kkt_factor(delta_w):
                Lh = _cholesky(H + delta_w[:, None, None] * eye_n)
                if not m:
                    return Lh, Lh.new_zeros((B, n, 0)), Lh.new_zeros(
                        (B, 0, 0))
                Y = tri(Lh, J.transpose(-1, -2), upper=False)
                S = Y.transpose(-1, -2) @ Y + \
                    delta_c[:, None, None] * eye_m
                return Lh, Y, _cholesky(S)

            def kkt_solve(fac, r1, r2):
                Lh, Y, Ls = fac
                w = tri(Lh, r1.unsqueeze(-1), upper=False)
                if not m:
                    dz = tri(Lh.transpose(-1, -2), w, upper=True)
                    return dz.squeeze(-1), r2
                # (J Hd^-1 J^T + delta_c I) dnu = Y^T w - r2
                rhs = Y.transpose(-1, -2) @ w - r2.unsqueeze(-1)
                t = tri(Ls, rhs, upper=False)
                dnu = tri(Ls.transpose(-1, -2), t, upper=True)
                dz = tri(Lh.transpose(-1, -2), w - Y @ dnu, upper=True)
                return dz.squeeze(-1), dnu.squeeze(-1)
        else:
            H = W + torch.diag_embed(Sig)

            def H_mv(v):
                return (H @ v.unsqueeze(-1)).squeeze(-1)

            def kkt_factor(delta_w):
                Hd = H + delta_w[:, None, None] * eye_n
                if m:
                    K = torch.cat([
                        torch.cat([Hd, J.transpose(-1, -2)], -1),
                        torch.cat([J, -delta_c[:, None, None] * eye_m], -1)],
                        -2)
                else:
                    K = Hd
                return _lu_factor(K)

            def kkt_solve(fac, r1, r2):
                LU, piv = fac
                rhs = torch.cat([r1, r2], -1) if m else r1
                sol = torch.linalg.lu_solve(LU, piv,
                                            rhs.unsqueeze(-1)).squeeze(-1)
                return sol[:, :n], sol[:, n:]

        def kkt_solve_refined(fac, delta, r1, r2):
            """kkt_solve + operator-form iterative refinement on the KKT
            residual (kkt_refine_iters=0 is a plain solve)."""
            dz, dnu = kkt_solve(fac, r1, r2)
            for _ in range(opt.kkt_refine_iters):
                Jt_dnu = vjp(c_fn, z)[1](dnu)[0]
                Jdz = jvp(c_fn, (z,), (dz,))[1]
                e1 = r1 - (H_mv(dz) + delta[:, None] * dz + Jt_dnu)
                e2 = r2 - (Jdz - delta_c[:, None] * dnu)
                ddz, ddnu = kkt_solve(fac, e1, e2)
                dz = dz + ddz
                dnu = dnu + ddnu
            return dz, dnu

        # ---- inertia-free regularization loop with delta warm-starting
        def try_delta(delta):
            fac = kkt_factor(delta)
            dz, dnu = kkt_solve_refined(fac, delta, rhs1, rhs2)
            dzdz = _dot(dz, dz)
            curv = _dot(dz, H_mv(dz)) + delta * dzdz
            curv_ok = curv >= 1e-9 * dzdz
            size_ok = _inf_norm(dz) <= 1e6 * torch.clamp(_inf_norm(z),
                                                         min=1.0)
            ok = torch.isfinite(dz).all(-1) & curv_ok & size_ok
            return delta, dz, dnu, ok, fac

        delta_first = torch.where(
            carry.delta_last > 0,
            torch.maximum(opt.delta_w_init * wscale, carry.delta_last / 3.0),
            0.0)
        delta, dz, dnu, ok, fac = try_delta(delta_first)
        tries = torch.zeros((B,), dtype=torch.int32, device=dev)
        while True:
            need = (~ok) & (tries < opt.max_reg)
            if not bool(need.any()):
                break
            new_delta = torch.clamp(
                torch.maximum(opt.delta_w_init * wscale, delta * 100.0),
                max=opt.delta_w_max)
            t_delta, t_dz, t_dnu, t_ok, t_fac = try_delta(new_delta)
            delta = torch.where(need, t_delta, delta)
            dz = _where(need, t_dz, dz)
            dnu = _where(need, t_dnu, dnu)
            ok = torch.where(need, t_ok, ok)
            # lanes that need no new trial keep their factor, field by
            # field
            merged = [_where(need, t, f) for t, f in zip(t_fac, fac)]
            fac = BTBFac(*merged) if use_btb else tuple(merged)
            tries = tries + need.to(torch.int32)

        dwL = torch.where(has_l, mu_col / dls - wL - SigL * dz, 0.0)
        dwU = torch.where(has_u, mu_col / dus - wU + SigU * dz, 0.0)
        tau = torch.clamp(1.0 - mu_new, min=opt.tau_min)

        def step_to_bounds(d):
            return torch.minimum(_max_step(dl, d, has_l, tau),
                                 _max_step(du, -d, has_u, tau))

        alpha_pr_max = step_to_bounds(dz)
        alpha_du = torch.minimum(_max_step(wL, dwL, has_l, tau),
                                 _max_step(wU, dwU, has_u, tau))

        # ---- filter line search (Waechter-Biegler 2006, Algorithm A)
        theta0 = _theta(cz)
        phi0 = _phi(z, mu_new)
        gphiTd = _dot(gphi, dz)
        theta_min = 1e-4 * carry.theta_scale

        def flt_ok(theta_t, phi_t):
            """(B, K) trial points not dominated by the lane's filter."""
            active = (slots < fcount[:, None])[:, None, :]
            dominated = (active &
                         (theta_t[..., None] >= ftheta[:, None, :]) &
                         (phi_t[..., None] >= fphi[:, None, :])).any(-1)
            return (~dominated) & torch.isfinite(theta_t)

        def test_alpha(alpha, z_t, c_t):
            """Acceptance of K trial points per lane: alpha (B, K),
            z_t (B, K, n), c_t (B, K, m)."""
            theta_t = _theta(c_t)
            phi_t = _phi(z_t, mu_col)
            t0c, p0c, g_c = theta0[:, None], phi0[:, None], gphiTd[:, None]
            switching = (g_c < 0) & \
                (alpha * g_c.abs() ** opt.s_phi >
                 opt.delta_switch * t0c ** opt.s_theta)
            armijo = phi_t <= p0c + opt.eta_phi * alpha * g_c
            suff = ((theta_t <= (1 - opt.gamma_theta) * t0c) |
                    (phi_t <= p0c - opt.gamma_phi * t0c))
            use_armijo = switching & (theta0 <= theta_min)[:, None]
            accept = flt_ok(theta_t, phi_t) & torch.where(use_armijo, armijo,
                                                          suff)
            return accept, use_armijo & armijo

        def test_one(alpha, z_t, c_t):
            acc, arm = test_alpha(alpha[:, None], z_t[:, None], c_t[:, None])
            return acc[:, 0], arm[:, 0]

        # full step, one second-order correction, then candidate-parallel
        # backtracking
        z_full = z + alpha_pr_max[:, None] * dz
        c_full = c_fn(z_full)
        acc_full, armi_full = test_one(alpha_pr_max, z_full, c_full)

        c_soc = alpha_pr_max[:, None] * cz + c_full
        dz_soc, _ = kkt_solve_refined(fac, delta, rhs1, -c_soc)
        alpha_soc = step_to_bounds(dz_soc)
        z_soc = z + alpha_soc[:, None] * dz_soc
        acc_soc_t, armi_soc = test_one(alpha_soc, z_soc, c_fn(z_soc))
        acc_soc = (~acc_full) & torch.isfinite(dz_soc).all(-1) & acc_soc_t

        # both branches of the JAX lax.cond: evaluate, then mask
        cand_alphas = alpha_pr_max[:, None] * halves
        z_cand = z[:, None, :] + cand_alphas[..., None] * dz[:, None, :]
        acc_c, armi_c = test_alpha(cand_alphas, z_cand, c_fn(z_cand))
        skip_bt = (acc_full | acc_soc)[:, None]
        acc_c = acc_c & ~skip_bt
        armi_c = armi_c & ~skip_bt
        acc_bt = acc_c.any(-1)
        first = torch.argmax(acc_c.to(torch.int32), -1, keepdim=True)
        alpha_bt = cand_alphas.gather(-1, first)[:, 0]
        armi_bt = armi_c.gather(-1, first)[:, 0]

        any_acc = acc_full | acc_soc | acc_bt
        alpha = torch.where(acc_full, alpha_pr_max,
                            torch.where(acc_soc, alpha_soc,
                                        torch.where(acc_bt, alpha_bt, 0.0)))
        z_acc = _where(acc_full, z_full,
                       _where(acc_soc, z_soc, z + alpha_bt[:, None] * dz))
        by_armijo = torch.where(acc_full, armi_full,
                                torch.where(acc_soc, armi_soc, armi_bt))

        # feasibility fallback when the filter rejects everything: a
        # pure-feasibility Newton step from the same factorization
        if m:
            dz_feas, _ = kkt_solve(fac, torch.zeros_like(z), -cz)
        else:
            dz_feas = torch.zeros_like(z)
        fb_alphas = step_to_bounds(dz_feas)[:, None] * halves
        fb_trial = z[:, None, :] + fb_alphas[..., None] * dz_feas[:, None, :]
        th_fb = _theta(c_fn(fb_trial))
        fb_ok = (torch.isfinite(th_fb) & (th_fb < theta0[:, None]) &
                 torch.isfinite(fb_trial).all(-1) & ~any_acc[:, None])
        feas_ok = fb_ok.any(-1)
        alpha_feas = fb_alphas.gather(
            -1, torch.argmax(fb_ok.to(torch.int32), -1, keepdim=True))[:, 0]
        z_feas = z + alpha_feas[:, None] * dz_feas
        z_new = _where(any_acc, z_acc, _where(feas_ok, z_feas, z))

        # filter augmentation: block this (theta, phi) region whenever the
        # step was not a pure Armijo step, and on the fallback
        add_entry = any_acc & ~by_armijo
        add_fb = ~any_acc
        slot = torch.clamp(fcount, max=FILTER_SIZE - 1)
        at_slot = slots[None, :] == slot[:, None]
        put = at_slot & (add_entry | add_fb)[:, None]
        ftheta_new = torch.where(put, ((1 - opt.gamma_theta) *
                                       theta0)[:, None], ftheta)
        fphi_new = torch.where(put, (phi0 - opt.gamma_phi *
                                     theta0)[:, None], fphi)
        fcount_new = torch.clamp(fcount + (add_entry | add_fb).to(torch.int32),
                                 max=FILTER_SIZE - 1)

        nu_new = nu + alpha[:, None] * dnu
        dl_n, du_n = _dl_du(z_new)
        dl_ns = torch.clamp(dl_n, min=1e-20)
        du_ns = torch.clamp(du_n, min=1e-20)
        # Newton step: dual update; fallback: re-center the bound duals on
        # the central path; no step: freeze them
        mu_fb = torch.clamp(mu_new * 10.0, max=mu_init)[:, None]
        wL_new = _where(any_acc, wL + alpha_du[:, None] * dwL,
                        _where(feas_ok, mu_fb / dl_ns, wL))
        wU_new = _where(any_acc, wU + alpha_du[:, None] * dwU,
                        _where(feas_ok, mu_fb / du_ns, wU))
        ks = opt.kappa_sigma
        wL_new = torch.where(has_l, torch.clamp(wL_new, min=mu_col /
                                                (ks * dl_ns),
                                                max=ks * mu_col / dl_ns), 0.0)
        wU_new = torch.where(has_u, torch.clamp(wU_new, min=mu_col /
                                                (ks * du_ns),
                                                max=ks * mu_col / du_ns), 0.0)

        # ---- divergence recovery and stall escape: restart from the best
        # iterate with mu-centered duals
        finite_ok = (torch.isfinite(z_new).all(-1) &
                     torch.isfinite(nu_new).all(-1) &
                     torch.isfinite(wL_new).all(-1) &
                     torch.isfinite(wU_new).all(-1))
        stagnant = any_acc & (e0 > 0.9 * carry.kkt)
        stall_count = torch.where(~any_acc, carry.stall_count + 1, 0)
        stall_reset = stall_count >= 8
        finite_ok = finite_ok & ~stall_reset
        stall_count = torch.where(stall_reset, 0, stall_count)
        have_best = torch.isfinite(carry.best_kkt)
        z_rec = _where(have_best, carry.best_z, z)
        z_new = _where(finite_ok, z_new, z_rec)
        nu_new = _where(finite_ok, nu_new,
                        _where(have_best, carry.best_nu, nu))
        dl_r, du_r = _dl_du(z_new)
        mu_ctr = mu_fb
        wL_new = _where(finite_ok, wL_new,
                        torch.where(has_l, mu_ctr /
                                    torch.clamp(dl_r, min=1e-20), 0.0))
        wU_new = _where(finite_ok, wU_new,
                        torch.where(has_u, mu_ctr /
                                    torch.clamp(du_r, min=1e-20), 0.0))
        ftheta_new = _where(finite_ok, ftheta_new, ft0)
        fphi_new = _where(finite_ok, fphi_new, fp0)
        fcount_new = torch.where(finite_ok, fcount_new, fc0)

        # mu rescue (non-monotone barrier) with a per-solve budget
        near_solution = e0 <= acc_tol
        dual0, primal0, comp0 = err_parts(zero_b)
        dual_dominates = dual0 > 10.0 * torch.maximum(primal0, comp0)
        allow_rescue = (carry.rescue_count < opt.max_rescues) & \
            ~dual_dominates
        mu_rescued = torch.where(
            (any_acc | near_solution | ~allow_rescue) & finite_ok, mu_new,
            torch.clamp(mu_new * 10.0, max=mu_init))
        rescue = mu_rescued != mu_new
        rescue_count = carry.rescue_count + \
            (rescue & finite_ok).to(torch.int32)
        ftheta_new = _where(rescue, ft0, ftheta_new)
        fphi_new = _where(rescue, fp0, fphi_new)
        fcount_new = torch.where(rescue, fc0, fcount_new)

        keep = converged
        return Carry(
            z=_where(keep, z, z_new),
            nu=_where(keep, nu, nu_new),
            wL=_where(keep, wL, wL_new),
            wU=_where(keep, wU, wU_new),
            mu=torch.where(keep, mu, mu_rescued),
            it=carry.it + (~keep).to(torch.int32),
            converged=converged,
            kkt=e0,
            alpha_last=alpha,
            # rejected or crawling steps escalate the next iteration's
            # starting regularization; good steps let it decay
            delta_last=torch.where(
                ~finite_ok, 0.0,
                torch.where(any_acc, delta,
                            torch.clamp(torch.maximum(
                                delta * 10.0, opt.delta_w_init * wscale),
                                max=opt.delta_w_max))),
            filter_theta=_where(keep, carry.filter_theta, ftheta_new),
            filter_phi=_where(keep, carry.filter_phi, fphi_new),
            filter_count=torch.where(keep, carry.filter_count, fcount_new),
            theta_scale=carry.theta_scale,
            best_z=best_z, best_nu=best_nu, best_kkt=best_kkt,
            acceptable_count=acceptable_count,
            rescue_count=torch.where(keep, carry.rescue_count, rescue_count),
            stall_count=torch.where(keep, carry.stall_count, stall_count),
            mu_wait=torch.where(
                keep, carry.mu_wait,
                torch.where((mu_rescued != mu) | ~stagnant, 0,
                            carry.mu_wait + 1)))

    def cond_fn(carry: Carry):
        """(B,) lanes still iterating."""
        return (~carry.converged) & (carry.it < opt.max_iter)

    def body_fn(carry: Carry, live=None) -> Carry:
        """One iteration for the live lanes (``live`` (B,), by default
        :func:`cond_fn`); the other lanes come back unchanged."""
        if live is None:
            live = cond_fn(carry)
        new = _step(carry)
        return Carry(*[_where(live, a, b) for a, b in zip(new, carry)])

    def finalize_fn(carry: Carry) -> IPMResult:
        # report the best iterate seen
        use_best = carry.best_kkt < carry.kkt
        z_out = _where(use_best, carry.best_z, carry.z)
        nu_out = _where(use_best, carry.best_nu, carry.nu)
        return IPMResult(z=to_full(z_out), nu=nu_out,
                         f=f_unscale * f_fn(z_out),
                         kkt_error=torch.minimum(carry.best_kkt, carry.kkt),
                         iterations=carry.it, converged=carry.converged)

    return init_fn, body_fn, cond_fn, finalize_fn


def make_chunked_solver(nlp: NLP, options: IPMOptions = IPMOptions(),
                        scale_z0=None, *, device="cuda",
                        dtype=torch.float64):
    """``(init_fn, run_chunk, finalize_fn)`` on ``device`` (the card unless
    the caller asks for the CPU), for solves taken in chunks (JAX
    ``ipm.py:1030``): ``run_chunk(carry, iter_limit)`` advances every live
    lane until it converges, reaches ``max_iter`` or reaches
    ``carry.it >= iter_limit``. The chunks take the same steps as one
    :func:`make_solver` solve; between them the caller may write the
    iterate out or stop (the reference's output_interval snapshots and
    FileDeletionThrower). TF32 is off in each of the three."""
    dev = resolve_device(device)
    init_fn, body_fn, cond_fn, finalize_fn = make_kernel(
        nlp, options, scale_z0, device=dev, dtype=dtype)

    def init(Z0) -> Carry:
        with full_precision(dev):
            return init_fn(Z0)

    def run_chunk(carry: Carry, iter_limit) -> Carry:
        with full_precision(dev):
            while True:
                live = cond_fn(carry) & (carry.it < iter_limit)
                if not bool(live.any()):
                    return carry
                carry = body_fn(carry, live)

    def finalize(carry: Carry) -> IPMResult:
        with full_precision(dev):
            return finalize_fn(carry)

    return init, run_chunk, finalize


def make_solver(nlp: NLP, options: IPMOptions = IPMOptions(), scale_z0=None,
                *, device="cuda", dtype=torch.float64) -> Callable:
    """``solve(Z0) -> IPMResult`` for a batch of starting points Z0 (B, n)
    (numpy or tensor), on ``device`` (the card unless the caller asks for
    the CPU): one chunk of :func:`make_chunked_solver` to ``max_iter``."""
    init_fn, run_chunk, finalize_fn = make_chunked_solver(
        nlp, options, scale_z0, device=device, dtype=dtype)

    def solve(Z0) -> IPMResult:
        return finalize_fn(run_chunk(init_fn(Z0), options.max_iter))

    return solve
