"""Forward time-stepping simulation.

Counterpart of ``opensim_moco_tpu.utils.rollout`` (the reference's
simulateTrajectoryWithTimeStepping, used by createGuessTimeStepping): RK4
over the same dynamics the transcription uses, controls interpolated
linearly in time, kinematic-constraint multipliers at zero. The JAX
package scans; here the steps are a plain loop over tensors on the
caller's device, one model evaluation per RK4 stage (on the card, one
RK4 step replayed as a CUDA graph).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device


def _interp_weights(t, t_grid):
    """(i0, i1, w) with ``x(t) = X[i0] + w * (X[i1] - X[i0])``, the
    arithmetic of ``jnp.interp`` (constant outside the grid)."""
    G = len(t_grid)
    i = int(np.clip(np.searchsorted(t_grid, t, side="right"), 1, G - 1))
    if t < t_grid[0]:
        return 0, 0, 0.0
    if t > t_grid[-1]:
        return G - 1, G - 1, 0.0
    dx = t_grid[i] - t_grid[i - 1]
    if abs(dx) <= np.spacing(np.finfo(np.float64).eps):
        return i - 1, i - 1, 0.0
    return i - 1, i, (t - t_grid[i - 1]) / dx


def _cuda_graphed(fn, *args):
    """``fn`` captured once into a CUDA graph on copies of its tensor
    arguments ``args``: a function of new arguments of the same shapes
    that copies them in, replays the graph and returns a copy of the
    output. The replay runs the captured kernels, so the result is the
    eager one bit for bit; it saves the host the per-operation dispatch,
    which is nearly all the time of one model call on the card. ``fn``
    must not read tensors on the host (the model calls do not)."""
    static = [a.clone() for a in args]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up: caches and library handles
        fn(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(*static)

    def run(*new):
        for a, b in zip(static, new):
            a.copy_(b)
        graph.replay()
        return out.clone()

    return run


def rollout(model, params, t_grid, controls, y0, substeps: int = 10):
    """RK4-integrate ``model`` under piecewise-linear controls.

    ``params``: the model's parameter dict on the device of ``y0`` (ny,);
    ``t_grid`` (G,): the times at which the rows of ``controls`` (G, nx)
    hold; ``substeps`` RK4 steps per grid interval. Returns the (G, ny)
    states at the grid times. Kinematic-constraint forces are not applied
    (lam = 0). On a CUDA device one RK4 step is captured as a CUDA graph
    and replayed step after step."""
    y = torch.as_tensor(y0)
    dev, dtype = y.device, y.dtype
    t_grid = np.asarray(t_grid, dtype=np.float64)
    X = torch.as_tensor(np.asarray(controls), dtype=dtype, device=dev)
    if len(t_grid) < 2:
        return y[None]
    # every step's stage times, controls and step size, made on the host,
    # sent once
    times, hs = [], []
    for i in range(len(t_grid) - 1):
        t0, t1 = t_grid[i], t_grid[i + 1]
        h = (t1 - t0) / substeps
        for k in range(substeps):
            t = t0 + k * h
            times += [t, t + 0.5 * h, t + h]
            hs.append(h)
    i0, i1, w = np.array([_interp_weights(t, t_grid)
                          for t in times]).reshape(-1, 3).T
    i0, i1 = (torch.as_tensor(a.astype(np.int64), device=dev)
              for a in (i0, i1))
    w = torch.as_tensor(w, dtype=dtype, device=dev)
    xs = (X[i0] + w.unsqueeze(-1) * (X[i1] - X[i0])).reshape(
        len(hs), 3, -1)
    ts = torch.as_tensor(np.asarray(times), dtype=dtype,
                         device=dev).reshape(-1, 3)
    hs = torch.as_tensor(np.asarray(hs), dtype=dtype, device=dev)
    lam = torch.zeros(model.nphi, dtype=dtype, device=dev)

    def f(t, x, yy):
        q, u, z = model.split_state(yy)
        return model.state_derivatives(params, t, q, u, z, x, lam)

    def step(yy, t3, x3, h):
        k1 = f(t3[0], x3[0], yy)
        k2 = f(t3[1], x3[1], yy + 0.5 * h * k1)
        k3 = f(t3[1], x3[1], yy + 0.5 * h * k2)
        k4 = f(t3[2], x3[2], yy + h * k3)
        return yy + h / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)

    if dev.type == "cuda":
        step = _cuda_graphed(step, y, ts[0], xs[0], hs[0])
    out = [y]
    s = 0
    for _ in range(len(t_grid) - 1):
        for _ in range(substeps):
            y = step(y, ts[s], xs[s], hs[s])
            s += 1
        out.append(y)
    return torch.stack(out)


def time_stepping_guess(transcription, controls=None, y0=None, t0=None,
                        tf=None, device="cuda"):
    """A flat numpy iterate from a forward simulation on ``device`` (the
    card unless the caller asks for the CPU; createGuessTimeStepping, JAX
    ``utils/rollout.py:74``): controls default to the bounds midpoint, y0
    to the midpoint's first state, the times to their bounds midpoints;
    the states are the rollout's, unclipped."""
    dev = resolve_device(device)
    tr = transcription
    rep = tr.rep
    mid = np.asarray(tr.initial_guess())
    t0v, tfv, Y, X, L, D, Gm, pcs, ecs, theta = tr.unpack(mid)
    t0v = float(t0v) if t0 is None else t0
    tfv = float(tfv) if tf is None else tf
    ts = t0v + (tfv - t0v) * np.asarray(tr.taus)
    if controls is None:
        controls = X
    if y0 is None:
        y0 = Y[0]
    params = rep.apply_parameters(
        torch.as_tensor(theta, device=dev),
        rep.model.default_params(dev))
    ys = rollout(rep.model, params, ts, controls,
                 torch.as_tensor(np.asarray(y0), device=dev))
    return tr.pack(t0v, tfv, ys.cpu().numpy(), controls, L, D, Gm, pcs, ecs,
                   theta)
