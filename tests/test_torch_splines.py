"""The port's splines (``opensim_moco_tpu_torch/utils/splines.py``) against
the JAX package's, float64 on the CPU: values, first and second
derivatives to 1e-12 of their magnitude, at random times, at the
breakpoints and outside the data range, for 1-D and multi-column data,
with fewer than 6 samples (scipy's ``make_interp_spline`` branch of the
quintic), and ``torch.func.jvp`` in t equal to ``.derivative``. Data drawn
with numpy from fixed seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu.utils import splines as jsp
from opensim_moco_tpu_torch.utils import splines as tsp

RTOL = 1e-12


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0.0, 2.0, n))
    x[0], x[-1] = 0.0, 2.0
    y = rng.standard_normal((n,) if d is None else (n, d))
    return x, y


def _times(x, seed):
    """Random times inside, the breakpoints, and times outside."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(x[0], x[-1], 13), x,
                           [x[0] - 0.3, x[-1] + 0.25, x[-1] + 1e-9]])


def _close(port, ref):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    scale = max(np.abs(ref).max(), 1.0)
    assert np.abs(port - ref).max() <= RTOL * scale


CASES = {"quintic_1d": ("QuinticSpline", 21, None),
         "quintic_3col": ("QuinticSpline", 17, 3),
         "quintic_5pts": ("QuinticSpline", 5, 2),
         "quintic_3pts_1d": ("QuinticSpline", 3, None),
         "quintic_2pts": ("QuinticSpline", 2, 2),
         "cubic_1d": ("CubicSpline", 12, None),
         "cubic_4col": ("CubicSpline", 9, 4),
         "cubic_2pts": ("CubicSpline", 2, None)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spline_matches_jax(case):
    cls, n, d = CASES[case]
    x, y = _data(n, d, seed=n)
    sj, st = getattr(jsp, cls)(x, y), getattr(tsp, cls)(x, y)
    ts = _times(x, seed=n + 1)
    t = torch.as_tensor(ts)
    for name in ("__call__", "derivative", "second_derivative"):
        fj = jax.jit(jax.vmap(getattr(sj, name)))
        _close(getattr(st, name)(t), fj(jnp.asarray(ts)))
    # any leading shape: (2, k) gives the same values as (2k,)
    k = len(ts) // 2
    _close(st(t[:2 * k].reshape(2, k)).reshape(st(t[:2 * k]).shape),
           st(t[:2 * k]).numpy())


@pytest.mark.parametrize("cls", ["QuinticSpline", "CubicSpline"])
def test_spline_jvp_and_vmap_in_time(cls):
    x, y = _data(15, 2, seed=4)
    sp = getattr(tsp, cls)(x, y)
    t = torch.as_tensor(_times(x, seed=5)[:13]).reshape(13)
    val, tan = torch.func.jvp(sp, (t,), (torch.ones_like(t),))
    _close(val, sp(t).numpy())
    _close(tan, sp.derivative(t).numpy())
    _, tan2 = torch.func.jvp(sp.derivative, (t,), (torch.ones_like(t),))
    _close(tan2, sp.second_derivative(t).numpy())
    lanes = torch.stack([t, t + 0.01])
    _close(torch.func.vmap(sp)(lanes), sp(lanes).numpy())
