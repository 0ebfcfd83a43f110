"""Parity of the PyTorch port's batched interior-point solver against the
JAX package, at the iterate and the solve level, plus the batching
semantics the port writes out by hand (frozen lanes, masked
regularization, lane independence).

Problem: the hanging muscle with full dynamics (activation, implicit
tendon compliance) at mesh 10, B=4 jittered starts, the bench's IPM
options with ``kkt="dense"`` on both sides, float64 on the CPU.

Tolerance for the carries after ``init_fn`` and three ``body_fn`` steps:
per lane, max |port - JAX| <= 1e-6 * max |JAX| for z, nu, wL and wU (the
dense LU of a KKT matrix with condition numbers near 1e10 amplifies
last-bit differences of the derivatives); mu and the iteration counters
must be equal.

Tolerance for whole solves: the converged flags must be equal, and the
objectives of the converged lanes must agree to relative 1e-2. Rounding
differences reroute a hard lane through a different sequence of iterates
(the JAX package itself moves lane 0 of this batch from f = 0.050730 in
38 iterations under ``kkt="dense"`` to f = 0.050890 in 34 under
``kkt="auto"``).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
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
             max_rescues=100, kkt="dense")
RTOL = 1e-6


@pytest.fixture(scope="module")
def problem():
    trj = jex.hanging_muscle_study(10, **FULL).transcription()
    trt = tex.hanging_muscle_study(10, **FULL).transcription()
    Z0 = batch_guesses(trt, 4, scale=0.05, seed=0)
    return trj, trt, Z0, trt.initial_guess()


@pytest.fixture(scope="module")
def port_kernel(problem):
    _, trt, _, z0 = problem
    return tipm.make_kernel(trt.make_nlp("cpu"), tipm.IPMOptions(**BENCH),
                            scale_z0=z0, device="cpu")


@pytest.fixture(scope="module")
def jax_kernel(problem):
    """The JAX package's kernel lane by lane (``per_lane``: the values of
    ``jit(vmap(.))``), compiled once for the iterate-level and the
    solve-level test."""
    trj, _, _, z0 = problem
    kern = jipm.make_kernel(trj.make_nlp(), jipm.IPMOptions(**BENCH),
                            scale_z0=z0)[:4]
    return tuple(per_lane(f) for f in kern)


def _jax_solve(jax_kernel, Z0):
    """``vmap(make_solver(...))`` of the JAX package with the while loop
    on the host: a batched ``lax.while_loop`` runs while any lane's
    condition holds and keeps the state of the other lanes."""
    init_j, body_j, cond_j, fin_j = jax_kernel
    with one_blas_thread():
        c = init_j(jnp.asarray(Z0))
        while True:
            live = cond_j(c)
            if not bool(live.any()):
                return jax.device_get(fin_j(c))
            c = jax.tree_util.tree_map(
                lambda a, b: jnp.where(
                    live.reshape(live.shape + (1,) * (a.ndim - 1)), a, b),
                body_j(c), c)


def _lane_close(port, ref, name):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, name
    for b in range(ref.shape[0]):
        scale = max(np.max(np.abs(ref[b])), 1e-300) if ref[b].size else 1.0
        err = np.max(np.abs(port[b] - ref[b])) if ref[b].size else 0.0
        assert err <= RTOL * scale, (name, b, err / scale)


def test_iterate_parity_with_jax(problem, port_kernel, jax_kernel):
    _, _, Z0, _ = problem
    init_j, body_j, _, _ = jax_kernel
    init_t, body_t, _, _ = port_kernel
    with one_blas_thread():
        cj = jax.block_until_ready(init_j(jnp.asarray(Z0)))
    ct = init_t(Z0)
    for step in range(4):
        if step:
            with one_blas_thread():
                cj = jax.block_until_ready(body_j(cj))
            ct = body_t(ct)
        for name in ("z", "nu", "wL", "wU"):
            _lane_close(getattr(ct, name), getattr(cj, name),
                        f"{name} after {step} body steps")
        for name in ("mu", "it", "converged", "filter_count",
                     "acceptable_count", "rescue_count", "stall_count",
                     "mu_wait"):
            np.testing.assert_array_equal(
                getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                err_msg=f"{name} after {step} body steps")


def test_batch_solve_parity_with_jax(problem, jax_kernel):
    _, trt, Z0, z0 = problem
    rj = _jax_solve(jax_kernel, Z0)
    rt = make_batched_solver(trt, tipm.IPMOptions(**BENCH), "cpu",
                             scale_z0=z0)(Z0)
    conv_j = np.asarray(rj.converged)
    np.testing.assert_array_equal(rt.converged.numpy(), conv_j)
    assert conv_j.any()
    f_j, f_t = np.asarray(rj.f), rt.f.numpy()
    np.testing.assert_allclose(f_t[conv_j], f_j[conv_j], rtol=1e-2)
    # the reported objective is f at the reported iterate
    nlp = trt.make_nlp("cpu")
    np.testing.assert_allclose(nlp.objective(rt.z).numpy(), f_t, rtol=1e-12)
    assert rt.z.shape == (4, trt.n) and rt.nu.shape == (4, nlp.m)
    assert rt.iterations.dtype == torch.int32
    assert (rt.iterations.numpy() <= BENCH["max_iter"]).all()


def test_lanes_are_independent(problem, port_kernel):
    """A lane solved inside a batch computes what it computes alone (the
    masked regularization loop and the both-branch line search must not
    leak between lanes). Batched and single-matrix BLAS calls sum in
    different orders, so the lanes agree to 1e-9 of their magnitude, not
    bit for bit."""
    _, _, Z0, _ = problem
    init_t, body_t, _, _ = port_kernel
    batch = init_t(Z0)
    alone = [init_t(Z0[b:b + 1]) for b in range(len(Z0))]
    for _ in range(3):
        batch = body_t(batch)
        alone = [body_t(c) for c in alone]
    for b, c in enumerate(alone):
        for name in ("z", "nu", "wL", "wU", "mu", "delta_last"):
            ref = getattr(c, name)[0].numpy()
            np.testing.assert_allclose(
                getattr(batch, name)[b].numpy(), ref, rtol=0,
                atol=1e-9 * max(np.max(np.abs(ref)), 1e-300), err_msg=name)
        assert torch.equal(batch.it[b], c.it[0])


def test_finished_lanes_stay_frozen(problem, port_kernel):
    _, _, Z0, _ = problem
    init_t, body_t, cond_t, _ = port_kernel
    carry = body_t(init_t(Z0))
    done = torch.tensor([False, True, False, False])
    at_limit = torch.tensor([False, False, True, False])
    carry = carry._replace(converged=carry.converged | done,
                           it=torch.where(at_limit, BENCH["max_iter"],
                                          carry.it))
    assert cond_t(carry).tolist() == [True, False, False, True]
    new = body_t(carry)
    for name, before, after in zip(carry._fields, carry, new):
        for b in (1, 2):
            np.testing.assert_array_equal(after[b].numpy(),
                                          before[b].numpy(), err_msg=name)
    assert not torch.equal(new.z[0], carry.z[0])


def test_singular_trial_is_nonfinite_not_an_error():
    """The regularization loop reads a non-finite step as "raise delta":
    factoring a singular KKT must neither raise nor synchronise."""
    K = torch.zeros(2, 4, 4, dtype=torch.float64)
    K[1] = torch.eye(4, dtype=torch.float64)
    LU, piv = tipm._lu_factor(K)
    x = torch.linalg.lu_solve(LU, piv, torch.ones(2, 4, 1,
                                                  dtype=torch.float64))
    assert not torch.isfinite(x[0]).all()
    assert torch.equal(x[1], torch.ones(4, 1, dtype=torch.float64))


def test_options_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jipm.IPMOptions)}
    tf = {f.name: f.default for f in dataclasses.fields(tipm.IPMOptions)}
    assert tf == jf


@pytest.mark.parametrize("opts,err", [
    (dict(kkt="btb"), ValueError),
    (dict(dense_factorization="qr"), ValueError),
])
def test_unported_options_raise(problem, opts, err):
    _, trt, _, _ = problem
    with pytest.raises(err):
        tipm.make_kernel(trt.make_nlp("cpu"), tipm.IPMOptions(**opts),
                         device="cpu")


def test_explicit_device_required(problem, monkeypatch):
    """The CPU needs an explicit device: every entry point defaults to the
    card, and without a card it raises rather than fall back."""
    _, trt, _, _ = problem
    entry_points = (tipm.make_solver, tipm.make_kernel, make_batched_solver,
                    trt.make_nlp, trt.rep.model.default_params,
                    tex.sliding_mass_study(5).solve)
    for fn in entry_points:
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    nlp = trt.make_nlp("cpu")
    for call in (lambda: tipm.make_solver(nlp, tipm.IPMOptions()),
                 lambda: tipm.make_kernel(nlp, device=None),
                 lambda: make_batched_solver(trt, tipm.IPMOptions()),
                 trt.make_nlp, trt.rep.model.default_params,
                 tex.sliding_mass_study(5).solve):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
