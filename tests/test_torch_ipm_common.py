"""Shared cases of the IPM parity tests under ``kkt="structured"`` and
``kkt="auto"`` (``test_torch_ipm_structured.py`` and
``test_torch_ipm_auto.py``: one file per mode, so that the two run on
two test workers).

Problem: the hanging muscle with full dynamics at mesh 10, B=4 jittered
starts, the bench's IPM options, float64 on the CPU. Under "structured"
every KKT factor is the bordered block-tridiagonal one; under "auto" at
this size (n+m < 1200) the derivatives are compressed, the step uses one
dense LU, and the least-squares multiplier start goes through btb.

Tolerance for the carries after ``init_fn`` and three ``body_fn`` steps:
per lane, max |port - JAX| <= 1e-5 * max |JAX| for z, nu, wL and wU, and
mu and the counters equal. Lane 0 of this batch is ill-conditioned: the
btb least-squares start (H = I, delta_c = 1e-8) leaves its multipliers
accurate to about 1e-8, and its next steps amplify that about a
hundredfold. The JAX package's own "structured" and "dense" modes (the
same mathematics) differ on lane 0 by 1.6e-6 after three steps; the
port's "structured" differs from the JAX package's by 2.9e-6 there and by
at most 3.4e-9 on the other lanes; under "auto" 2.9e-6 and 3.4e-9
(measured on the CPU). 1e-5 is the JAX package's own spread on that lane,
with a margin.

Tolerance for whole solves: every lane that converges in the JAX package
converges in the port, and the objectives of those lanes agree to
relative 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu.solver import ipm as jipm
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.parallel import batch_guesses, make_batched_solver
from opensim_moco_tpu_torch.solver import ipm as tipm
from test_torch_constrained_common import one_blas_thread, per_lane

torch.set_num_threads(2)

FULL = dict(ignore_tendon_compliance=False, ignore_activation_dynamics=False,
            tendon_dynamics_implicit=True)
BENCH = dict(tol=3e-3, max_iter=200, bound_relax=1e-6, mu_init=1e-2,
             kappa_eps=100.0, acceptable_tol_factor=30.0, acceptable_iter=10,
             max_rescues=100)
RTOL = 1e-5


def make_problem():
    trj = jex.hanging_muscle_study(10, **FULL).transcription()
    trt = tex.hanging_muscle_study(10, **FULL).transcription()
    Z0 = batch_guesses(trt, 4, scale=0.05, seed=0)
    return trj, trt, Z0, trt.initial_guess()


def make_kernels(problem, mode):
    """The JAX package's kernel lane by lane (``per_lane``: the values of
    ``jit(vmap(.))``) and the port's, in the same ``kkt`` mode."""
    trj, trt, _, z0 = problem
    opts = dict(BENCH, kkt=mode)
    jk = jipm.make_kernel(trj.make_nlp(), jipm.IPMOptions(**opts),
                          scale_z0=z0)[:4]
    tk = tipm.make_kernel(trt.make_nlp("cpu"), tipm.IPMOptions(**opts),
                          scale_z0=z0, device="cpu")
    return mode, tuple(per_lane(f) for f in jk), tk


def _lane_close(port, ref, name):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, name
    for b in range(ref.shape[0]):
        scale = max(np.max(np.abs(ref[b])), 1e-300) if ref[b].size else 1.0
        err = np.max(np.abs(port[b] - ref[b])) if ref[b].size else 0.0
        assert err <= RTOL * scale, (name, b, err / scale)


def check_iterate_parity(problem, kernels):
    with one_blas_thread():
        _iterate_parity(problem, kernels)


def _iterate_parity(problem, kernels):
    _, _, Z0, _ = problem
    _, (init_j, body_j, _, _), (init_t, body_t, _, _) = kernels
    cj, ct = init_j(jnp.asarray(Z0)), init_t(Z0)
    for step in range(4):
        if step:
            cj, ct = body_j(cj), body_t(ct)
        for name in ("z", "nu", "wL", "wU"):
            _lane_close(getattr(ct, name), getattr(cj, name),
                        f"{name} after {step} body steps")
        for name in ("mu", "it", "converged", "filter_count",
                     "acceptable_count", "rescue_count", "stall_count",
                     "mu_wait"):
            np.testing.assert_array_equal(
                getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                err_msg=f"{name} after {step} body steps")


def check_batch_solve_parity(problem, kernels):
    """``vmap(make_solver(...))`` of the JAX package, with the batched
    while loop on the host, against the port's batched solver."""
    _, trt, Z0, z0 = problem
    mode, (init_j, body_j, cond_j, fin_j), _ = kernels
    with one_blas_thread():
        c = init_j(jnp.asarray(Z0))
        while bool(cond_j(c).any()):
            live = cond_j(c)
            c = jax.tree_util.tree_map(
                lambda a, b: jnp.where(
                    live.reshape(live.shape + (1,) * (a.ndim - 1)), a, b),
                body_j(c), c)
        rj = jax.device_get(fin_j(c))
    rt = make_batched_solver(trt, tipm.IPMOptions(**BENCH, kkt=mode), "cpu",
                             scale_z0=z0)(Z0)
    conv_j = np.asarray(rj.converged)
    assert conv_j.any()
    assert rt.converged.numpy()[conv_j].all()
    np.testing.assert_allclose(rt.f.numpy()[conv_j],
                               np.asarray(rj.f)[conv_j], rtol=1e-2)
