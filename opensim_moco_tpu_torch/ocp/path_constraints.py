"""Canned path constraints.

Counterpart of ``opensim_moco_tpu.ocp.path_constraints``
(MocoControlBoundConstraint and MocoFrameDistanceConstraint). Each
factory returns ``(fn, lower, upper)`` for ``Problem.add_path_constraint``;
``fn`` takes the port's batched arguments (t (..., P), y (..., P, ny),
x (..., P, nx)) and returns (..., P, k).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.mech import _const_vec


def control_bound_constraint(control_names, lower_fn=None, upper_fn=None):
    """Keep controls within time-varying bounds (JAX
    ``ocp/path_constraints.py:16``). ``lower_fn``/``upper_fn``: callables
    of the time tensor. Per control, the one-sided residuals
    x - lo(t) >= 0 and hi(t) - x >= 0."""

    def fn(rep, t, y, x, lam, p):
        out = []
        for name in control_names:
            i = rep.control_names.index(name)
            if lower_fn is not None:
                out.append(x[..., i] - lower_fn(t))
            if upper_fn is not None:
                out.append(upper_fn(t) - x[..., i])
        return torch.stack(out, -1)

    k = len(control_names) * ((lower_fn is not None) +
                              (upper_fn is not None))
    return fn, np.zeros(k), np.full(k, np.inf)


def frame_distance_constraint(pairs, min_distance, max_distance,
                              projection=None):
    """Bound the distance between pairs of body-fixed points (JAX
    ``ocp/path_constraints.py:40``). ``pairs``: ((bodyA, locA, bodyB,
    locB), ...); optional ``projection``: a unit 3-vector whose component
    is removed from the separation first."""

    def fn(rep, t, y, x, lam, p):
        m = rep.model
        q = y[..., :m.nq]
        frames = m.mech.frames(p["mech"], q)
        point = m.mech._station_world
        out = []
        for (ba, la, bb, lbv) in pairs:
            d = point(frames, bb, lbv, q) - point(frames, ba, la, q)
            if projection is not None:
                proj = _const_vec(projection, q)
                d = d - (d * proj).sum(-1, keepdim=True) * proj
            out.append(torch.sqrt((d * d).sum(-1) + 1e-12))
        return torch.stack(torch.broadcast_tensors(*out), -1)

    k = len(pairs)
    return fn, np.full(k, float(min_distance)), np.full(k,
                                                        float(max_distance))
