"""Interpolating splines evaluated on tensors.

Counterpart of ``opensim_moco_tpu.utils.splines``: the natural cubic
spline (``CubicSpline``, JAX ``utils/splines.py:17``), the natural quintic
spline of the reference's PositionMotion (``QuinticSpline``, JAX
``:192``) and the numpy resampler of trajectories (``quintic_resample``,
JAX ``:161``). Coefficients are computed once with numpy/scipy, by the
same routines as in the JAX package; evaluation is ``torch.searchsorted``
and Horner's rule on a time tensor of any leading shape, with analytic
first and second derivatives. Everything is differentiable in ``t`` under
``torch.func`` transforms (``jvp``, ``vmap``), as the transcription needs
when the time window is free. Times outside the data range extrapolate
the end segments, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch


class _Coefficients:
    """numpy arrays turned into tensors once per (device, dtype)."""

    def __init__(self, **arrays):
        self._np = arrays
        self._cache = {}

    def on(self, like):
        key = (like.device, like.dtype)
        if key not in self._cache:
            # made outside any torch.func transform the first call may sit
            # in, so that the cached tensors belong to no transform level
            with torch._C._DisableFuncTorch():
                self._cache[key] = {
                    k: torch.as_tensor(v, dtype=like.dtype,
                                       device=like.device)
                    for k, v in self._np.items()}
        return self._cache[key]


def _segment(knots, t, nseg):
    """Index of the segment holding ``t``, clipped to [0, nseg - 1]
    (JAX ``searchsorted(side="right") - 1``)."""
    i = torch.searchsorted(knots, t.contiguous(), right=True) - 1
    return torch.clamp(i, 0, nseg - 1)


def _rows(a, i):
    """``a[i]`` for an index tensor ``i`` of any shape, also a 0-d one
    under ``vmap`` (where ``a[i]`` would read the index on the host)."""
    return a.index_select(0, i.reshape(-1)).reshape(i.shape + a.shape[1:])


class CubicSpline:
    """Natural cubic spline through (x, y) with analytic derivatives (JAX
    ``utils/splines.py:17``). ``y`` is (n,) or (n, d); a value at ``t``
    (...) is (...) or (..., d)."""

    def __init__(self, x, y):
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        n = len(x)
        assert n >= 2 and y.shape[0] == n
        h = np.diff(x)
        if n == 2:
            M = np.zeros((2,) + y.shape[1:])
        else:
            # tridiagonal system for the second derivatives, natural ends
            A = np.zeros((n, n))
            rhs = np.zeros_like(y)
            A[0, 0] = 1.0
            A[-1, -1] = 1.0
            for i in range(1, n - 1):
                A[i, i - 1] = h[i - 1]
                A[i, i] = 2 * (h[i - 1] + h[i])
                A[i, i + 1] = h[i]
                rhs[i] = 6 * ((y[i + 1] - y[i]) / h[i] -
                              (y[i] - y[i - 1]) / h[i - 1])
            M = np.linalg.solve(A, rhs.reshape(n, -1)).reshape(y.shape)
        self.n = n
        # each segment as a cubic in dt = t - x_i (the same spline as the
        # JAX package's form in A = (x_{i+1} - t) / h, B = (t - x_i) / h):
        # few operations with a constant operand, which forward-mode
        # derivatives make costly
        h = h.reshape((-1,) + (1,) * (y.ndim - 1))
        M0, M1 = M[:-1], M[1:]
        d = (M1 - M0) / (6.0 * h)
        self._c = _Coefficients(
            x=x, a=y[:-1],
            b=(y[1:] - y[:-1]) / h - h * (2.0 * M0 + M1) / 6.0,
            c=M0 / 2.0, d=d, c2=M0, d3=3.0 * d, d6=6.0 * d)

    def _parts(self, t, *names):
        c = self._c.on(t)
        i = _segment(c["x"], t, self.n - 1)
        dt = t - _rows(c["x"], i)
        if c["a"].dim() > 1:  # per-column values: broadcast over d
            dt = dt.unsqueeze(-1)
        return (dt,) + tuple(_rows(c[k], i) for k in names)

    def __call__(self, t):
        dt, a, b, c, d = self._parts(t, "a", "b", "c", "d")
        return ((d * dt + c) * dt + b) * dt + a

    def derivative(self, t):
        dt, b, c2, d3 = self._parts(t, "b", "c2", "d3")
        return (d3 * dt + c2) * dt + b

    def second_derivative(self, t):
        dt, c2, d6 = self._parts(t, "c2", "d6")
        return d6 * dt + c2


def _natural_quintic_coeffs(x, Y):
    """Natural interpolating quintic spline coefficients: the minimum
    ∫(f''')² interpolant (Woltring's GCVSPL with half-order 3 and no
    smoothing, the reference's GCVSpline(5) in PositionMotion), from the
    KKT system [[Ω, Bᵀ], [B, 0]] [c, μ] = [0, y] of the quintic B-spline
    basis with single interior knots at the data sites (B its collocation
    matrix, Ω_ij = ∫ B_i''' B_j'''). A copy of JAX
    ``utils/splines.py:82``; solved in normalized time s = (x - x0)/h_mean
    for conditioning, then mapped back.

    Returns (breakpoints, (6, nseg, d) PPoly coefficients, highest power
    first)."""
    from scipy.interpolate import BSpline, PPoly

    n = len(x)
    x_raw = np.asarray(x, dtype=np.float64)
    h_mean = float(np.mean(np.diff(x_raw)))
    x0 = float(x_raw[0])
    x = (x_raw - x0) / h_mean
    t = np.r_[[x[0]] * 6, x[1:-1], [x[-1]] * 6]
    nb = n + 4
    B = BSpline.design_matrix(x, t, 5).toarray()  # (n, nb)
    # f''' is piecewise quadratic: 3-point Gauss-Legendre is exact
    gauss_x = np.array([-np.sqrt(3.0 / 5.0), 0.0, np.sqrt(3.0 / 5.0)])
    gauss_w = np.array([5.0 / 9.0, 8.0 / 9.0, 5.0 / 9.0])
    a = x[:-1]
    b = x[1:]
    h2 = 0.5 * (b - a)
    pts = (0.5 * (a + b)[:, None] + h2[:, None] * gauss_x[None, :]).ravel()
    w = (h2[:, None] * gauss_w[None, :]).ravel()
    D3 = BSpline(t, np.eye(nb), 5)(pts, nu=3)  # (npts, nb)
    Om = (D3 * w[:, None]).T @ D3
    K = np.zeros((nb + n, nb + n))
    K[:nb, :nb] = Om
    K[:nb, nb:] = B.T
    K[nb:, :nb] = B
    rhs = np.zeros((nb + n, Y.shape[1]))
    rhs[nb:] = Y
    c = np.linalg.solve(K, rhs)[:nb]
    cols = []
    for j in range(Y.shape[1]):
        pp = PPoly.from_spline(BSpline(t, c[:, j], 5))
        cols.append((pp.x, pp.c))
    xb = cols[0][0]
    C = np.stack([cc for _, cc in cols], axis=-1)  # (6, nseg, d)
    # back to raw time: the coefficient of (t - t_i)^e is c_e / h_mean^e
    k = C.shape[0] - 1
    for m in range(C.shape[0]):
        C[m] /= h_mean ** (k - m)
    return x0 + h_mean * xb, C


def quintic_resample(x, Y, new_x):
    """Resample a table ``Y`` (n, d) from grid ``x`` onto ``new_x`` with
    the natural quintic interpolant, in numpy (a copy of JAX
    ``utils/splines.py:161``; the reference's GCVSplineSet of degree
    min(5, n - 1) in MocoTrajectory::resample). Tables of 5 samples or
    fewer take scipy's interpolating spline of degree min(3, n - 1).
    Times outside the data range are clamped to it."""
    from scipy.interpolate import PPoly, make_interp_spline

    x = np.asarray(x, dtype=np.float64)
    Y = np.asarray(Y, dtype=np.float64)
    new_x = np.asarray(new_x, dtype=np.float64)
    if Y.ndim == 1:
        Y = Y[:, None]
    if Y.shape[1] == 0:
        return np.zeros((len(new_x), 0))
    if len(x) == 1:
        return np.repeat(Y, len(new_x), axis=0)
    tq = np.clip(new_x, x[0], x[-1])
    if len(x) > 5:
        xb, C = _natural_quintic_coeffs(x, Y)
        return np.stack([PPoly(C[:, :, j], xb)(tq)
                         for j in range(Y.shape[1])], axis=1)
    k = max(1, min(3, len(x) - 1))
    return np.stack([make_interp_spline(x, Y[:, j], k=k)(tq)
                     for j in range(Y.shape[1])], axis=1)


class QuinticSpline:
    """Interpolating natural quintic spline (the reference's GCVSpline of
    degree 5 with no smoothing, used by PositionMotion; JAX
    ``utils/splines.py:192``). With fewer than 6 samples it is scipy's
    ``make_interp_spline`` of degree n - 1, as in the JAX package.
    ``y`` is (n,) or (n, d); a value at ``t`` (...) is (...) or
    (..., d)."""

    def __init__(self, x, y):
        from scipy.interpolate import PPoly, make_interp_spline

        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        squeeze = y.ndim == 1
        Y = y[:, None] if squeeze else y
        if len(x) > 5:
            xb, C = _natural_quintic_coeffs(x, Y)
        else:
            k = max(1, len(x) - 1)
            cols = []
            for j in range(Y.shape[1]):
                pp = PPoly.from_spline(make_interp_spline(x, Y[:, j], k=k))
                cols.append((pp.x, pp.c))
            xb = cols[0][0]
            C = np.stack([c for _, c in cols], axis=-1)  # (k+1, nseg, d)
        self.squeeze = squeeze
        self.order = C.shape[0]
        self.nseg = C.shape[1]
        # Horner coefficients of the value and its first two derivatives,
        # (nseg, order - deriv, d), highest power first: the derivative of
        # c_m dt^e (e = order - 1 - m) is c_m e dt^(e - 1)
        k = self.order - 1
        horner = {}
        for deriv in range(3):
            rows = []
            for m in range(self.order - deriv):
                e = k - m
                fac = 1.0
                for r in range(deriv):
                    fac *= (e - r)
                rows.append(C[m] * fac)
            horner[f"d{deriv}"] = (np.stack(rows, axis=1) if rows else
                                   np.zeros((self.nseg, 1, C.shape[-1])))
        self._c = _Coefficients(xb=xb, **horner)

    def _eval(self, t, deriv):
        c = self._c.on(t)
        i = _segment(c["xb"], t, self.nseg)
        dt = (t - _rows(c["xb"], i)).unsqueeze(-1)
        coef = _rows(c[f"d{deriv}"], i)  # (..., order - deriv, d)
        out = coef[..., 0, :]
        for m in range(1, coef.shape[-2]):
            out = out * dt + coef[..., m, :]
        return out[..., 0] if self.squeeze else out

    def __call__(self, t):
        return self._eval(t, 0)

    def derivative(self, t):
        return self._eval(t, 1)

    def second_derivative(self, t):
        return self._eval(t, 2)
