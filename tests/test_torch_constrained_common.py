"""Shared checks of the constrained-problem parity tests
(``test_torch_path_constraints.py``, ``test_torch_parameters.py``,
``test_torch_kinematic_constraints.py``): one JAX transcription and its
port counterpart, float64 on the CPU, inputs drawn with numpy from a
fixed seed. No tests of its own.

* layout, bounds, initial guess, constraint groups and jittered batch
  guesses: exactly equal (the same numpy computations);
* c(z) and f(z) at the guess and at a jittered point (and, given
  multipliers, the gradient of the Lagrangian): relative 1e-12 of the
  largest magnitude (same formulas, only summation order differs), and a
  batch of points evaluates like each point alone (1e-14); the JAX side
  in one jitted function, compiled once;
* the KKT structure's index lists, its compiled index arrays and their
  free-variable projection: exactly equal;
* the compressed Jacobian and Hessian blocks at two lanes of points and
  multipliers, the constraints gradient-scaled as the IPM scales them:
  relative 1e-10 of the largest magnitude (``test_torch_structured.py``'s
  tolerance);
* iterate parity of the IPM, ``init_fn`` and three ``body_fn`` steps:
  per lane max |port - JAX| <= rtol * max |JAX| for z, nu, wL and wU, mu
  and the counters equal (rtol as ``test_torch_ipm_common.py`` explains:
  1e-6 dense, 1e-5 structured). Chained, each package steps from its own
  carry; unchained, the port steps from the JAX package's carry, so each
  step is compared alone. The double pendulum's lane 1 needs that under
  ``kkt="structured"``: there the JAX package's own "structured" and
  "dense" modes (the same mathematics) drift apart to 2.1e-3 in three
  chained steps, and the port's "structured" drifts from the JAX
  package's by 3.0e-4 (measured on the CPU).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from threadpoolctl import threadpool_limits
from torch.func import grad

from opensim_moco_tpu import examples as _jex  # noqa: F401  (see below)
from opensim_moco_tpu.parallel import batch_guesses as jax_batch_guesses
from opensim_moco_tpu.solver import ipm as jipm
from opensim_moco_tpu.solver import kkt as jkkt
from opensim_moco_tpu.solver import structured as js
from opensim_moco_tpu_torch.parallel import batch_guesses
from opensim_moco_tpu_torch.solver import ipm as tipm
from opensim_moco_tpu_torch.solver import structured as ts
from opensim_moco_tpu_torch.solver.kkt import CompiledStructure

# the JAX package's ``parallel`` imported first runs into its own import
# cycle (parallel -> transcribe -> ocp -> transcribe); ``examples`` above
# loads ``ocp`` first, as every other parity test does
torch.set_num_threads(2)


def one_blas_thread():
    """A context in which numpy's and scipy's OpenBLAS, which the JAX
    package's LAPACK calls run on, use one thread (the port's torch keeps
    its own). With several test workers on the cores, OpenBLAS's spinning
    threads slow each other down many-fold: the JAX side of a batched IPM
    solve took 24 s alone and 400 s beside three more, 70 s with one
    thread each (an 8-core CPU). JAX dispatches asynchronously, so block
    on its results inside the context."""
    return threadpool_limits(limits=1, user_api="blas")


def per_lane(fn):
    """``fn``, a function of one point, over the leading axis of its
    arguments (pytrees): the values of ``jax.jit(jax.vmap(fn))``, with
    ``fn`` compiled once for one point and called point by point. The JAX
    package's functions trace and compile in about 30% less time
    unbatched (its IPM step on the hanging muscle 28 s against 39 s, the
    wrapped chain's quantities 26 s against 39 s, an 8-core CPU); the
    calls cost milliseconds."""
    f = jax.jit(fn)

    def run(*args):
        n = jax.tree_util.tree_leaves(args)[0].shape[0]
        outs = [f(*jax.tree_util.tree_map(lambda a: a[k], args))
                for k in range(n)]
        return jax.tree_util.tree_map(lambda *a: jnp.stack(a), *outs)

    return run


def rel(port, ref):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if not ref.size:
        return 0.0
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300))


def points(tr, seed=0):
    """The guess and a jittered point inside the bounds."""
    z0 = tr.initial_guess()
    lb, ub = tr.bounds()
    rng = np.random.default_rng(seed)
    width = np.where(np.isfinite(ub - lb), ub - lb, 1.0)
    z1 = np.clip(z0 + 0.05 * width * rng.uniform(-1, 1, z0.shape), lb, ub)
    return [z0, z1]


def jax_nlp(trj):
    """The JAX transcription's NLP, built once per transcription and then
    reused: each ``make_nlp`` traces the whole constraint function again
    (7 s on the walker at mesh 3)."""
    if not hasattr(trj, "_parity_nlp"):
        trj._parity_nlp = trj.make_nlp()
    return trj._parity_nlp


def check_layout(trj, trt):
    assert trt.offsets == trj.offsets
    assert (trt.n, trt.G, trt.n_gamma, trt.n_pc_slack, trt.npar) == \
        (trj.n, trj.G, trj.n_gamma, trj.n_pc_slack, trj.npar)
    for a, b in zip(trt.bounds(), trj.bounds()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(trt.initial_guess(), trj.initial_guess())
    assert trt.constraint_group_info() == trj.constraint_group_info()
    np.testing.assert_array_equal(
        batch_guesses(trt, 3, scale=0.05, seed=3),
        np.asarray(jax_batch_guesses(trj, 3, scale=0.05, seed=3)))


def check_functions(trj, trt, nu=None):
    """c(z) and f(z) at ``points``; with multipliers ``nu`` (m,) also the
    gradient of the Lagrangian f + c . nu. The JAX side is one jitted
    function of z (and nu), compiled once."""
    nj, nt = jax_nlp(trj), trt.make_nlp("cpu")
    assert (nt.n, nt.m) == (nj.n, nj.m)
    if nu is None:
        funcs_j = jax.jit(lambda z: (nj.constraints(z), nj.objective(z)))
    else:
        def lag_j(z, nn):
            return nj.objective(z) + nj.constraints(z) @ nn

        funcs_j = jax.jit(lambda z, nn: (nj.constraints(z), nj.objective(z),
                                         jax.grad(lag_j)(z, nn)))
        nut = torch.as_tensor(nu)
    pts = points(trt)
    for z in pts:
        zt = torch.as_tensor(z)
        out_j = funcs_j(jnp.asarray(z)) if nu is None else funcs_j(
            jnp.asarray(z), jnp.asarray(nu))
        assert rel(nt.constraints(zt), out_j[0]) <= 1e-12
        assert rel(nt.objective(zt), out_j[1]) <= 1e-12
        if nu is not None:
            g_t = grad(lambda zz: nt.objective(zz) +
                       (nt.constraints(zz) * nut).sum())(zt)
            assert rel(g_t, out_j[2]) <= 1e-12
    Z = torch.as_tensor(np.stack(pts))
    C, F = nt.constraints(Z), nt.objective(Z)
    for k, z in enumerate(pts):
        zt = torch.as_tensor(z)
        assert rel(C[k], nt.constraints(zt).numpy()) <= 1e-14
        assert rel(F[k], nt.objective(zt).numpy()) <= 1e-14


def _compiled(nlp, cls):
    st = nlp.structure
    return cls(st.var_blocks, st.con_blocks, st.border_vars, st.border_cons,
               nlp.n, nlp.m)


def check_structure(trj, trt):
    nj, nt = jax_nlp(trj), trt.make_nlp("cpu")
    sj, st = nj.structure, nt.structure
    assert sj is not None and st is not None
    assert st.var_blocks == sj.var_blocks
    assert st.con_blocks == sj.con_blocks
    np.testing.assert_array_equal(st.border_vars, sj.border_vars)
    np.testing.assert_array_equal(st.border_cons, sj.border_cons)
    csj, cst = _compiled(nj, jkkt.CompiledStructure), _compiled(
        nt, CompiledStructure)
    lb, ub = np.asarray(nt.lb), np.asarray(nt.ub)
    free = np.nonzero(~(np.isfinite(lb) & (lb == ub)))[0]
    for a, b in ((cst, csj), (cst.remap_free(free), csj.remap_free(free))):
        assert (a.N, a.nv, a.nc, a.n, a.m) == (b.N, b.nv, b.nc, b.n, b.m)
        for name in ("V", "Vm", "C", "Cm", "bv", "bc"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                          err_msg=name)


def check_blocks(trj, trt, objective_only=False):
    """Compressed Jacobian and Hessian blocks of both packages at two
    lanes (the JAX side jitted lane by lane); with ``objective_only`` the
    Hessian is the objective's alone, as under
    ``hessian_approximation="objective-only"``."""
    nj, nt = jax_nlp(trj), trt.make_nlp("cpu")
    rng = np.random.default_rng(0)
    Z = np.stack(points(trt))
    NU = rng.standard_normal((2, nt.m))
    # the row scaling, one input of both sides, from the port's Jacobian
    # (held to the JAX package's through c(z) and the J blocks)
    J0 = torch.func.jacfwd(nt.constraints)(torch.as_tensor(Z[0])).numpy()
    c_scale = np.minimum(1.0, 100.0 / np.maximum(np.abs(J0).max(1), 1e-8))
    cj = jnp.asarray(c_scale)
    c_fn_j = lambda zz: cj * nj.constraints(zz)  # noqa: E731
    bd_j = js.BlockDerivatives(_compiled(nj, jkkt.CompiledStructure), c_fn_j,
                               nj.objective)
    lag_j = jax.grad(lambda zz, nn: nj.objective(zz) +
                     (0.0 if objective_only else c_fn_j(zz) @ nn))
    jac_j = jax.jit(bd_j.jac_blocks)
    hess_j = jax.jit(lambda z, nu: bd_j.hess_blocks(lag_j, z, nu))

    ct = torch.as_tensor(c_scale)
    c_fn_t = lambda zz: ct * nt.constraints(zz)  # noqa: E731
    bd_t = ts.BlockDerivatives(_compiled(nt, CompiledStructure), c_fn_t, "cpu")

    def lag_t(zz, nn):
        if objective_only:
            return grad(lambda q: nt.objective(q).sum())(zz)
        return grad(lambda q: (nt.objective(q) +
                               (c_fn_t(q) * nn).sum(-1)).sum())(zz)

    Zt, NUt = torch.as_tensor(Z), torch.as_tensor(NU)
    jb_t, hb_t = bd_t.jac_blocks(Zt), bd_t.hess_blocks(lag_t, Zt, NUt)
    for lane in range(2):
        z, nu = jnp.asarray(Z[lane]), jnp.asarray(NU[lane])
        jb, hb = jax.device_get(jac_j(z)), jax.device_get(hess_j(z, nu))
        for name in ("Jcv", "Jc0v1", "Jcb", "Jbc"):
            assert rel(jb_t[name][lane], jb[name]) <= 1e-10, name
        for name in ("Hvv", "Hvb", "Hbb"):
            assert rel(hb_t[name][lane], hb[name]) <= 1e-10, name


def _lane_close(port, ref, rtol, name):
    port = port.numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, name
    for b in range(ref.shape[0]):
        scale = max(np.max(np.abs(ref[b])), 1e-300) if ref[b].size else 1.0
        err = np.max(np.abs(port[b] - ref[b])) if ref[b].size else 0.0
        assert err <= rtol * scale, (name, b, err / scale)


def _port_carry(cj):
    return tipm.Carry(*[torch.as_tensor(np.array(a)) for a in cj])


def check_iterate_parity(trj, trt, opts, rtol, lanes=4, chained=True,
                         scaled=True):
    """JAX ``make_kernel`` lane by lane (``per_lane``) against the port's, from
    ``lanes`` jittered starts, scaled at the guess (unscaled with
    ``scaled=False``)."""
    with one_blas_thread():
        _iterate_parity(trj, trt, opts, rtol, lanes, chained, scaled)


def _iterate_parity(trj, trt, opts, rtol, lanes, chained, scaled):
    z0 = trt.initial_guess() if scaled else None
    Z0 = batch_guesses(trt, lanes, scale=0.05, seed=0)
    init_j, body_j = (per_lane(f) for f in jipm.make_kernel(
        jax_nlp(trj), jipm.IPMOptions(**opts), scale_z0=z0)[:2])
    init_t, body_t, _, _ = tipm.make_kernel(
        trt.make_nlp("cpu"), tipm.IPMOptions(**opts), scale_z0=z0,
        device="cpu")
    cj, ct = init_j(jnp.asarray(Z0)), init_t(Z0)
    for step in range(4):
        if step:
            ct = body_t(ct if chained else _port_carry(cj))
            cj = body_j(cj)
        for name in ("z", "nu", "wL", "wU"):
            _lane_close(getattr(ct, name), getattr(cj, name), rtol,
                        f"{name} after {step} body steps")
        for name in ("mu", "it", "converged", "filter_count",
                     "acceptable_count", "rescue_count", "stall_count",
                     "mu_wait"):
            np.testing.assert_array_equal(
                getattr(ct, name).numpy(), np.asarray(getattr(cj, name)),
                err_msg=f"{name} after {step} body steps")
