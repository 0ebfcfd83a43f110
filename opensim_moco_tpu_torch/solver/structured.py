"""Compressed block derivatives and the bordered block-tridiagonal KKT.

Counterpart of ``opensim_moco_tpu.solver.structured``, batched over lanes:
every tensor carries a leading lane dimension B, as in the port's IPM.

Direct-collocation NLPs have a bordered block-tridiagonal sparsity in the
time axis, and the transcription knows it (``solver.nlp.KKTStructure``),
so the coloring is analytic:

* constraint rows of interval block ``i`` touch variable blocks ``i`` and
  ``i+1`` only, so the Jacobian is upper block-bidiagonal + border and is
  recovered from ``2·nv + kv`` forward tangents (2-coloring over interval
  parity, plus one tangent per border variable) instead of ``n``;
* every constraint and cost integrand is a per-grid-point function
  combined linearly across points, so the Lagrangian Hessian is
  block-diagonal + border, recovered from ``nv + kv`` forward-over-reverse
  tangents (one color);
* border constraint rows (endpoint goals) are computed exactly by ``kc``
  reverse-mode passes: they may couple distant blocks.

The recovered blocks feed the bordered block-tridiagonal ("btb")
factorization: factor once per regularization trial, then solve the Newton
step, the second-order correction and the feasibility fallback as cheap
extra right-hand sides. ``btb_factor``/``btb_solve`` here are the plain
PyTorch versions (a Python loop over the N blocks); on a CUDA tensor the
IPM calls the hand-written kernel in ``ops/btb.py`` instead, which runs
the same recursion in one launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import jvp, vjp, vmap

from .kkt import CompiledStructure

# on large grids (N >= 32) one vmap call takes at most SEED_LANES
# (lane, seed) pairs, and never fewer than SEED_CHUNK seeds
SEED_CHUNK = 16
SEED_LANES = 2048


def lu_factor(K):
    """Pivoted LU of a batch (..., k, k) with no error check (a singular
    factor shows up as NaN/inf in the solve, never as an exception).

    On the CPU the batch is factored one matrix at a time: MKL's batched
    ``getrf`` under ATen's multi-threaded batch loop hangs for k above a
    few hundred (torch 2.13, more than one thread). On CUDA one batched
    call factors every matrix."""
    if K.device.type == "cpu":
        flat = K.reshape((-1,) + K.shape[-2:])
        facs = [torch.linalg.lu_factor_ex(k) for k in flat]
        return (torch.stack([f[0] for f in facs]).reshape(K.shape),
                torch.stack([f[1] for f in facs]).reshape(K.shape[:-1]))
    LU, piv, _ = torch.linalg.lu_factor_ex(K)
    return LU, piv


def cholesky_factor(K):
    """Lower Cholesky factor of a batch (..., k, k); a matrix that is not
    positive definite gives an all-NaN factor in its own slot and no
    exception, as ``jnp.linalg.cholesky`` does (the regularization loop
    reads the NaN step as "raise delta").

    On the CPU the batch is factored one matrix at a time, as
    :func:`lu_factor` does; on CUDA one batched call."""
    if K.device.type == "cpu":
        flat = K.reshape((-1,) + K.shape[-2:])
        facs = [torch.linalg.cholesky_ex(k) for k in flat]
        L = torch.stack([f[0] for f in facs]).reshape(K.shape)
        info = torch.stack([f[1] for f in facs]).reshape(K.shape[:-2])
    else:
        L, info = torch.linalg.cholesky_ex(K)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


def _seeded_jvp(fn, z, seeds, n_blocks):
    """Tangents of ``fn`` at z (B, n) along each seed (S, n): (B, S, out).

    ``vmap`` of ``jvp`` over the seeds. On large grids (N >= 32 blocks) the
    seeds go through in chunks, so that the evaluation tape is batched by
    at most ``SEED_LANES`` (lane, seed) pairs: ``SEED_LANES // B`` seeds a
    chunk, at least ``SEED_CHUNK`` (the JAX package's
    ``lax.map(batch_size=16)``). Each chunk is a whole eager pass of the
    function, so at few lanes the larger chunks cut the launches of an
    iteration several times over."""
    def one(s):
        return jvp(fn, (z,), (s.expand_as(z),))[1]

    chunk = seeds.shape[0] if n_blocks < 32 else \
        max(SEED_CHUNK, SEED_LANES // z.shape[0])
    out = torch.cat([vmap(one)(seeds[i:i + chunk])
                     for i in range(0, seeds.shape[0], chunk)])
    return out.transpose(0, 1)


class BlockIndex:
    """A CompiledStructure's index arrays as tensors on one device, plus
    the gathers that scatter block vectors back to the flat layout."""

    def __init__(self, cs: CompiledStructure, device, dtype=torch.float64):
        self.N, self.nv, self.nc = cs.N, cs.nv, cs.nc
        self.n, self.m = cs.n, cs.m
        self.kv, self.kc = len(cs.bv), len(cs.bc)
        self.k = self.kv + self.kc
        self.nb = self.nv + self.nc

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int64), device=device)

        self.V, self.C = idx(cs.V), idx(cs.C)
        self.Vs = idx(np.where(cs.Vm, cs.V, cs.n))  # padding -> n
        self.Cs = idx(np.where(cs.Cm, cs.C, cs.m))  # padding -> m
        self.bv, self.bc = idx(cs.bv), idx(cs.bc)
        self.mv = torch.as_tensor(cs.Vm, dtype=dtype, device=device)
        self.mc = torch.as_tensor(cs.Cm, dtype=dtype, device=device)
        # flat (n,) from cat([block values (N*nv), border values (kv)])
        self.v_from_blocks = idx(self._inverse(cs.V, cs.Vm, cs.bv, cs.n))
        self.c_from_blocks = idx(self._inverse(cs.C, cs.Cm, cs.bc, cs.m))

    @staticmethod
    def _inverse(idx, mask, border, size):
        pos = np.empty(size, np.int64)
        flat = np.nonzero(mask.ravel())[0]
        pos[idx.ravel()[flat]] = flat
        pos[border] = idx.size + np.arange(len(border))
        return pos

    def vars_from_blocks(self, xv, xb):
        """(B, n) from per-block values (B, N, nv) and border (B, kv)."""
        flat = torch.cat([xv.reshape(xv.shape[0], -1), xb], -1)
        return flat.index_select(-1, self.v_from_blocks)

    def cons_from_blocks(self, xc, xb):
        """(B, m) from per-block values (B, N, nc) and border (B, kc)."""
        flat = torch.cat([xc.reshape(xc.shape[0], -1), xb], -1)
        return flat.index_select(-1, self.c_from_blocks)


class BlockDerivatives:
    """Compressed-seed derivative extraction for a CompiledStructure.

    ``c_fn`` takes (..., n). Index bookkeeping is numpy at build
    time; the extraction is gathers plus one ``vmap``ped ``jvp`` over the
    (small) seed set for all lanes at once."""

    def __init__(self, cs: CompiledStructure, c_fn, device,
                 dtype=torch.float64):
        self.c_fn = c_fn
        self.ix = ix = BlockIndex(cs, device, dtype)
        N, nv, n = cs.N, cs.nv, cs.n
        kv = ix.kv

        # seeds: the masked (block, local-var) pairs index the seed rows
        bidx, jidx = np.nonzero(cs.Vm)
        cols = cs.V[bidx, jidx]
        SJ = np.zeros((2 * nv + kv, n))  # 2-coloring over parity + border
        SJ[(bidx % 2) * nv + jidx, cols] = 1.0
        SJ[2 * nv + np.arange(kv), cs.bv] = 1.0
        SH = np.zeros((nv + kv, n))  # one color + border
        SH[jidx, cols] = 1.0
        SH[nv + np.arange(kv), cs.bv] = 1.0
        self.SJ = torch.as_tensor(SJ, dtype=dtype, device=device)
        self.SH = torch.as_tensor(SH, dtype=dtype, device=device)

        # compressed column of (block i, local var j) for var block i
        # (jj_same) and for var block i+1 seen from con block i (jj_next)
        par = np.arange(N) % 2
        same = par[:, None] * nv + np.arange(nv)[None, :]
        nxt = (1 - par)[:, None] * nv + np.arange(nv)[None, :]
        self.jj_same = torch.as_tensor(same, device=device)
        self.jj_next = torch.as_tensor(nxt[:-1], device=device)

    # ------------------------------------------------------------ Jacobian
    def jac_blocks(self, z):
        """Jacobian blocks at z (B, n), masked and zero-padded:

        Jcv    (B, N, nc, nv)    J[C_i, V_i]
        Jc0v1  (B, N-1, nc, nv)  J[C_i, V_{i+1}]
        Jcb    (B, N, nc, kv)    J[C_i, bv]
        Jbc    (B, kc, n)        exact border rows

        J[C_{i+1}, V_i] is structurally zero (rows of con block i never
        touch var block i-1) and is not stored."""
        ix = self.ix
        B = z.shape[0]
        N, nc, nv = ix.N, ix.nc, ix.nv
        Jc = _seeded_jvp(self.c_fn, z, self.SJ, N).transpose(1, 2)
        if ix.kc:
            _, c_vjp = vjp(self.c_fn, z)
            eye = torch.zeros((ix.kc, B, ix.m), dtype=z.dtype,
                              device=z.device)
            eye[torch.arange(ix.kc, device=z.device), :, ix.bc] = 1.0
            Jbc = vmap(lambda ct: c_vjp(ct)[0])(eye).transpose(0, 1)
        else:
            Jbc = z.new_zeros((B, 0, ix.n))
        JC = Jc[:, ix.C]  # (B, N, nc, 2nv+kv)
        mc = ix.mc[:, :, None]
        Jcv = JC.gather(3, self.jj_same[None, :, None, :].expand(
            B, N, nc, nv)) * mc * ix.mv[:, None, :]
        Jc0v1 = JC[:, :-1].gather(3, self.jj_next[None, :, None, :].expand(
            B, N - 1, nc, nv)) * mc[:-1] * ix.mv[1:, None, :]
        Jcb = JC[..., 2 * nv:] * mc
        return dict(Jcv=Jcv, Jc0v1=Jc0v1, Jcb=Jcb, Jbc=Jbc)

    # ------------------------------------------------------------- Hessian
    def hess_blocks(self, lag_grad_fn, z, nu):
        """Blocks of H = d(lag_grad)/dz at z (B, n), nu (B, m):

        Hvv  (B, N, nv, nv)  H[V_i, V_i]
        Hvb  (B, N, nv, kv)  H[V_i, bv]
        Hbb  (B, kv, kv)     H[bv, bv]

        ``lag_grad_fn(z, nu)`` is the per-lane gradient of the Lagrangian,
        (B, n). H has no cross-block coupling and it is not stored."""
        ix = self.ix
        nv = ix.nv
        Hc = _seeded_jvp(lambda zz: lag_grad_fn(zz, nu), z, self.SH,
                         ix.N).transpose(1, 2)  # (B, n, nv+kv)
        HV = Hc[:, ix.V]  # (B, N, nv, nv+kv)
        mv = ix.mv
        Hvv = HV[..., :nv] * mv[:, :, None] * mv[:, None, :]
        Hvv = 0.5 * (Hvv + Hvv.transpose(-1, -2))  # fp only; exact in math
        Hvb = HV[..., nv:] * mv[:, :, None]
        Hbb = Hc[:, ix.bv][..., nv:]
        Hbb = 0.5 * (Hbb + Hbb.transpose(-1, -2))
        return dict(Hvv=Hvv, Hvb=Hvb, Hbb=Hbb)

    # ------------------------------------------- scaling (gradient-based)
    def jac_row_inf_norms(self, z):
        """max_j |J[r, j]| per row at one point z (n,), as numpy (m,), from
        one compressed pass (compressed columns of non-border rows never
        alias; border rows are exact)."""
        ix = self.ix
        jb = self.jac_blocks(z[None])
        row = jb["Jcv"][0].abs().amax(-1)  # (N, nc)
        if ix.kv:
            row = torch.maximum(row, jb["Jcb"][0].abs().amax(-1))
        nxt = jb["Jc0v1"][0].abs().amax(-1)
        row = torch.cat([torch.maximum(row[:-1], nxt), row[-1:]])
        border = (jb["Jbc"][0].abs().amax(-1) if ix.kc
                  else row.new_zeros(0))
        return ix.cons_from_blocks(row[None], border[None])[0].cpu().numpy()


def assemble_kkt_blocks(hb, jb, sigma, delta_w, delta_c, ix: BlockIndex):
    """(D, L, B, C) of the permuted KKT matrix, per lane,

        [[H + Sigma + delta_w I,  J^T     ],
         [J,                      -delta_c I]]

    ordered [v_0 c_0 | v_1 c_1 | ... | border], from Hessian/Jacobian
    blocks (see BlockDerivatives), the diagonal barrier term ``sigma``
    (B, n) and per-lane ``delta_w``, ``delta_c`` (B,). Padded rows/cols
    become identity rows with zero rhs. Shapes: D (B, N, nb, nb),
    L (B, N-1, nb, nb) (block (i+1, i)), B (B, N, nb, k), C (B, k, k)."""
    N, nv, nc, kv, kc = ix.N, ix.nv, ix.nc, ix.kv, ix.kc
    Hvv = hb["Hvv"]
    Bsz, dtype, dev = Hvv.shape[0], Hvv.dtype, Hvv.device
    mv, mc = ix.mv, ix.mc
    dw = delta_w[:, None, None]
    dc = delta_c[:, None, None]
    eye_v = torch.eye(nv, dtype=dtype, device=dev)

    sig_pad = torch.cat([sigma, sigma.new_zeros((Bsz, 1))], -1)
    sigV = sig_pad[:, ix.Vs] * mv  # (B, N, nv)
    Dvv = Hvv + (sigV + dw * mv)[..., None] * eye_v + \
        eye_v * (1.0 - mv)[..., None]
    zeros = Hvv.new_zeros
    if nc:
        Jcv = jb["Jcv"]
        eye_c = torch.eye(nc, dtype=dtype, device=dev)
        Dcc = -dc[..., None] * eye_c * mc[..., None] - \
            eye_c * (1.0 - mc)[..., None]
        D = torch.cat([torch.cat([Dvv, Jcv.transpose(-1, -2)], -1),
                       torch.cat([Jcv, Dcc], -1)], -2)
        L = torch.cat([
            torch.cat([zeros((Bsz, N - 1, nv, nv)),
                       jb["Jc0v1"].transpose(-1, -2)], -1),
            zeros((Bsz, N - 1, nc, nv + nc))], -2)
    else:
        D = Dvv
        L = zeros((Bsz, N - 1, nv, nv))

    if kc:
        Jbc = jb["Jbc"]
        Jbc_pad = torch.cat([Jbc, zeros((Bsz, kc, 1))], -1)
        Jbcv = Jbc_pad[:, :, ix.Vs].permute(0, 2, 3, 1) * mv[..., None]
        Jbb = Jbc[:, :, ix.bv]  # (B, kc, kv)
    else:
        Jbcv = zeros((Bsz, N, nv, 0))
        Jbb = zeros((Bsz, 0, kv))
    Bm = torch.cat([hb["Hvb"], Jbcv], -1)  # (B, N, nv, k)
    if nc:
        Bc = torch.cat([jb["Jcb"], zeros((Bsz, N, nc, kc))], -1)
        Bm = torch.cat([Bm, Bc], -2)
    Hbb_r = hb["Hbb"] + torch.diag_embed(sig_pad[:, ix.bv]) + \
        dw * torch.eye(kv, dtype=dtype, device=dev)
    C = torch.cat([
        torch.cat([Hbb_r, Jbb.transpose(-1, -2)], -1),
        torch.cat([Jbb, -dc * torch.eye(kc, dtype=dtype, device=dev)], -1)],
        -2)
    return D, L, Bm, C


class BTBFac(NamedTuple):
    """Factorization of the bordered block-tridiagonal KKT matrix, per lane
    (one factorization serves the Newton step, the second-order correction
    and the feasibility fallback). Pivots are 1-based row indices, as
    ``torch.linalg.lu_factor`` gives them."""
    S_lu: torch.Tensor  # (B, N, nb, nb) LU of the Schur blocks
    S_piv: torch.Tensor  # (B, N, nb) int32
    L: torch.Tensor  # (B, N-1, nb, nb) subdiagonal blocks
    B: torch.Tensor  # (B, N, nb, k) border blocks
    Tinv_B: torch.Tensor  # (B, N, nb, k)
    Sb_lu: torch.Tensor  # (B, k, k) LU of the border Schur complement
    Sb_piv: torch.Tensor  # (B, k) int32


def _t_solve(S_lu, S_piv, L, rhs):
    """Solve T x = rhs with the stored block factors; rhs (B, N, nb, r)."""
    N = rhs.shape[1]
    ys = [rhs[:, 0]]
    for i in range(1, N):
        # y_i = r_i - L_{i-1} S_{i-1}^{-1} y_{i-1}
        prev = torch.linalg.lu_solve(S_lu[:, i - 1], S_piv[:, i - 1], ys[-1])
        ys.append(rhs[:, i] - L[:, i - 1] @ prev)
    xs = [torch.linalg.lu_solve(S_lu[:, -1], S_piv[:, -1], ys[-1])]
    for i in range(N - 2, -1, -1):
        xs.append(torch.linalg.lu_solve(
            S_lu[:, i], S_piv[:, i],
            ys[i] - L[:, i].transpose(-1, -2) @ xs[-1]))
    return torch.stack(xs[::-1], 1)


def btb_factor(D, L, B, C) -> BTBFac:
    """Factor [[T, B], [B^T, C]] per lane; T block-tridiagonal from the
    diagonal blocks D (B, N, nb, nb) and subdiagonal blocks L
    (B, N-1, nb, nb). Plain PyTorch: a loop over the N blocks."""
    N = D.shape[1]
    lu, piv = lu_factor(D[:, 0])
    lus, pivs = [lu], [piv]
    for i in range(1, N):
        # S_i = D_i - L_{i-1} S_{i-1}^{-1} L_{i-1}^T
        W = torch.linalg.lu_solve(lu, piv, L[:, i - 1].transpose(-1, -2))
        lu, piv = lu_factor(D[:, i] - L[:, i - 1] @ W)
        lus.append(lu)
        pivs.append(piv)
    S_lu, S_piv = torch.stack(lus, 1), torch.stack(pivs, 1)
    if B.shape[-1] == 0:
        Sb = C.new_zeros(C.shape[:1] + (0, 0))
        return BTBFac(S_lu, S_piv, L, B, B, Sb,
                      S_piv.new_zeros(C.shape[:1] + (0,)))
    Tinv_B = _t_solve(S_lu, S_piv, L, B)
    Sb_lu, Sb_piv = lu_factor(C - torch.einsum("bnik,bnij->bkj", B, Tinv_B))
    return BTBFac(S_lu, S_piv, L, B, Tinv_B, Sb_lu, Sb_piv)


def btb_solve(fac: BTBFac, rhs_T, rhs_C):
    """Solve [[T, B], [B^T, C]] [x; w] = [rhs_T; rhs_C] from a BTBFac.
    rhs_T (B, N, nb[, r]), rhs_C (B, k[, r]); x and w keep that form."""
    single = rhs_T.dim() == 3
    if single:
        rhs_T, rhs_C = rhs_T[..., None], rhs_C[..., None]
    x = _t_solve(fac.S_lu, fac.S_piv, fac.L, rhs_T)
    if fac.B.shape[-1] == 0:
        w = rhs_C
    else:
        w = torch.linalg.lu_solve(
            fac.Sb_lu, fac.Sb_piv,
            rhs_C - torch.einsum("bnik,bnir->bkr", fac.B, x))
        x = x - torch.einsum("bnik,bkr->bnir", fac.Tinv_B, w)
    return (x[..., 0], w[..., 0]) if single else (x, w)


def dense_kkt(D, L, B, C):
    """[[T, B], [B^T, C]] assembled dense, (B, N nb + k, N nb + k), from the
    blocks ``btb_factor`` takes: the yardstick the btb path is checked
    against."""
    Bt, N, nb, _ = D.shape
    k = B.shape[-1]
    K = D.new_zeros((Bt, N * nb + k, N * nb + k))
    for i in range(N):
        s = slice(i * nb, (i + 1) * nb)
        K[:, s, s] = D[:, i]
        if i + 1 < N:
            t = slice((i + 1) * nb, (i + 2) * nb)
            K[:, t, s] = L[:, i]
            K[:, s, t] = L[:, i].transpose(-1, -2)
    Bf = B.reshape(Bt, N * nb, k)
    K[:, :N * nb, N * nb:] = Bf
    K[:, N * nb:, :N * nb] = Bf.transpose(-1, -2)
    K[:, N * nb:, N * nb:] = C
    return K


def block_H_diag(hb, ix: BlockIndex):
    """diag(H) (B, n) from Hessian blocks."""
    return ix.vars_from_blocks(torch.diagonal(hb["Hvv"], 0, -2, -1),
                               torch.diagonal(hb["Hbb"], 0, -2, -1))


def block_H_matvec(hb, ix: BlockIndex, v):
    """H @ v (B, n) from Hessian blocks (block-diagonal + border)."""
    vV = v[:, ix.V] * ix.mv  # (B, N, nv)
    vb = v[:, ix.bv]  # (B, kv)
    yV = torch.einsum("bnij,bnj->bni", hb["Hvv"], vV) + \
        torch.einsum("bnik,bk->bni", hb["Hvb"], vb)
    yb = torch.einsum("bnik,bni->bk", hb["Hvb"], vV) + \
        torch.einsum("bkj,bj->bk", hb["Hbb"], vb)
    return ix.vars_from_blocks(yV, yb)


def pack_rhs(r1, r2, ix: BlockIndex):
    """Permute (r1 (B, n), r2 (B, m)) into (rhs_T (B, N, nb),
    rhs_C (B, k))."""
    rhs_T = torch.cat([r1[:, ix.V] * ix.mv, r2[:, ix.C] * ix.mc], -1)
    rhs_C = torch.cat([r1[:, ix.bv], r2[:, ix.bc]], -1)
    return rhs_T, rhs_C


def unpack_sol(x, w, ix: BlockIndex):
    """Permuted solution (x (B, N, nb), w (B, k)) back to (dz (B, n),
    dnu (B, m))."""
    nv, kv = ix.nv, ix.kv
    return (ix.vars_from_blocks(x[..., :nv], w[:, :kv]),
            ix.cons_from_blocks(x[..., nv:], w[:, kv:]))


def dense_J_from_blocks(jb, ix: BlockIndex):
    """Scatter Jacobian blocks into a dense (B, m, n) tensor. For problems
    small enough that one dense LU beats the block recursion, this keeps
    the compressed-derivative saving: J costs 2·nv + kv tangents, not n."""
    Jcv = jb["Jcv"]
    Bsz = Jcv.shape[0]
    J = Jcv.new_zeros((Bsz, ix.m + 1, ix.n + 1))
    rows = ix.Cs[:, :, None]
    J[:, rows, ix.Vs[:, None, :]] = Jcv
    J[:, rows[:-1], ix.Vs[1:, None, :]] = jb["Jc0v1"]
    J[:, rows, ix.bv[None, None, :]] = jb["Jcb"]
    J[:, ix.bc, :ix.n] = jb["Jbc"]
    return J[:, :ix.m, :ix.n]


def dense_H_from_blocks(hb, ix: BlockIndex):
    """Scatter Hessian blocks into a dense (B, n, n) tensor."""
    Hvv = hb["Hvv"]
    H = Hvv.new_zeros((Hvv.shape[0], ix.n + 1, ix.n + 1))
    Vr, Vc = ix.Vs[:, :, None], ix.Vs[:, None, :]
    bv = ix.bv[None, None, :]
    H[:, Vr, Vc] = Hvv
    H[:, Vr, bv] = hb["Hvb"]
    H[:, bv, Vr] = hb["Hvb"]
    H[:, ix.bv[:, None], ix.bv[None, :]] = hb["Hbb"]
    return H[:, :ix.n, :ix.n]
