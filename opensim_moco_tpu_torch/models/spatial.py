"""Spatial (6D) rigid-body algebra on tensors with leading batch dims.

Featherstone conventions, as in ``opensim_moco_tpu.models.spatial``: a
motion vector is ``[omega; v]``, the motion transform for (E, r) is
``[[E, 0], [-E r^, E]]`` and forces transform with its transpose.

Every function accepts arbitrary leading dimensions (``...``) and creates
no tensor from host data, so it runs unchanged on the grid, across lanes
and under ``torch.func`` transforms.
"""

from __future__ import annotations

import numpy as np
import torch


def mv(A, v):
    """Batched matrix-vector product ``A @ v`` over leading dims."""
    return (A @ v.unsqueeze(-1)).squeeze(-1)


def block2x2(A, B, C, D):
    """``[[A, B], [C, D]]`` with the four blocks broadcast to one leading
    shape."""
    A, B, C, D = torch.broadcast_tensors(A, B, C, D)
    return torch.cat([torch.cat([A, B], -1), torch.cat([C, D], -1)], -2)


def skew(v):
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix (hat operator)."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], -1),
        torch.stack([v[..., 2], z, -v[..., 0]], -1),
        torch.stack([-v[..., 1], v[..., 0], z], -1),
    ], -2)


def rodrigues(axis, theta):
    """Active rotation R(axis, theta) for a static unit ``axis`` (3
    numbers) and a tensor angle ``theta`` of shape (...): (..., 3, 3).

    The JAX package's ``I + sin K + (1 - cos) K K``, with K built from the
    static axis on the host, written as (I + K K) + sin K - cos K K: for an
    axis along a coordinate every entry is 0, 1 or +-sin or cos, with no
    operation between a constant and the angle (which forward-mode
    derivatives make costly)."""
    a = np.asarray(axis, dtype=np.float64)
    K = np.array([[0.0, -a[2], a[1]], [a[2], 0.0, -a[0]],
                  [-a[1], a[0], 0.0]])
    K2 = K @ K
    base = np.eye(3) + K2
    s = torch.sin(theta)
    c = torch.cos(theta)

    def scaled(x, k):
        return x if k == 1.0 else (-x if k == -1.0 else x * float(k))

    rows = []
    for i in range(3):
        row = []
        for j in range(3):
            e = None
            for x, k in ((s, K[i, j]), (c, -K2[i, j])):
                if k != 0.0:
                    e = scaled(x, k) if e is None else e + scaled(x, k)
            if e is None:
                e = torch.full_like(s, float(base[i, j]))
            elif base[i, j] != 0.0:
                e = e + float(base[i, j])
            row.append(e)
        rows.append(torch.stack(row, -1))
    return torch.stack(rows, -2)


def xform(E, r):
    """Motion transform ``[[E, 0], [-E r^, E]]``."""
    return block2x2(E, torch.zeros_like(E), -E @ skew(r), E)


def xform_inv_T(E, r):
    """Force transform (X^{-T}) for (E, r): ``[[E, -E r^], [0, E]]``."""
    return block2x2(E, -E @ skew(r), torch.zeros_like(E), E)


def cross(a, b):
    """a x b over the last dim, the leading dims broadcast."""
    return torch.linalg.cross(*torch.broadcast_tensors(a, b))


def crm(v):
    """Spatial cross product (motion x motion): ``crm(v) @ m``."""
    w = skew(v[..., :3])
    return block2x2(w, torch.zeros_like(w), skew(v[..., 3:]), w)


def crf(v):
    """Spatial cross product (motion x force): ``-crm(v)^T``."""
    return -crm(v).transpose(-1, -2)


def spatial_inertia(mass, com, inertia_about_com):
    """6x6 spatial inertia about the body-frame origin from the mass,
    the COM in body coordinates and the 3x3 inertia about the COM."""
    c = skew(com)
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    m = mass[..., None, None]
    upper_left = inertia_about_com + m * (c @ c.transpose(-1, -2))
    return block2x2(upper_left, m * c, m * c.transpose(-1, -2), m * eye)
