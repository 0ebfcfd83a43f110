"""Parity of the port's structured KKT path against the JAX package.

For hanging muscle (full dynamics and simplified, Hermite-Simpson, mesh 6)
and the trapezoidal sliding mass (mesh 6), on the CPU in float64:

* the KKT structure ``make_nlp`` attaches, the CompiledStructure index
  arrays and their ``remap_free`` projection equal the JAX package's
  exactly (a row in the wrong block would alias silently under
  compression);
* ``jac_blocks``, ``hess_blocks`` and ``jac_row_inf_norms`` equal the JAX
  package's at the same z and nu to relative 1e-10 of the largest
  magnitude (same graph, same seeds; only summation order differs);
* the KKT blocks from ``assemble_kkt_blocks`` equal the JAX package's to
  relative 1e-12, and the plain ``btb_factor``/``btb_solve`` match the
  JAX package's ``btb_solve`` to relative 1e-10 and solve the assembled
  KKT to a residual of at most 1e-10 of max|K| max|x| (as
  ``tests/test_structured_kkt.py`` measures it). The constraints are
  gradient-scaled first, as the IPM scales them.

Plus the block helpers against dense autodiff and the structure's
guards. K1 and the plain btb on their own are in
``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu.solver import kkt as jkkt
from opensim_moco_tpu.solver import structured as js
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.ocp import Goal
from opensim_moco_tpu_torch.solver import structured as ts
from opensim_moco_tpu_torch.solver.kkt import CompiledStructure

torch.set_num_threads(2)

CASES = {
    "hanging_full": lambda m: m.hanging_muscle_study(
        6, ignore_tendon_compliance=False, ignore_activation_dynamics=False,
        tendon_dynamics_implicit=True),
    "hanging_simplified": lambda m: m.hanging_muscle_study(
        6, ignore_tendon_compliance=True, ignore_activation_dynamics=True),
    "sliding_mass_trapezoidal": lambda m: m.sliding_mass_study(
        6, "trapezoidal"),
}


def _rel(port, ref):
    port = port.detach().cpu().numpy() if torch.is_tensor(port) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    if not ref.size:
        return 0.0
    return float(np.abs(port - ref).max() / max(np.abs(ref).max(), 1e-300))


def _free_idx(nlp):
    lb, ub = np.asarray(nlp.lb), np.asarray(nlp.ub)
    return np.nonzero(~(np.isfinite(lb) & (lb == ub)))[0]


def _compiled(nlp, cls):
    st = nlp.structure
    return cls(st.var_blocks, st.con_blocks, st.border_vars, st.border_cons,
               nlp.n, nlp.m)


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """Both packages' NLPs, compiled structures (full and free-variable),
    and two lanes of points and multipliers drawn with numpy."""
    trj = CASES[request.param](jex).transcription()
    trt = CASES[request.param](tex).transcription()
    nj, nt = trj.make_nlp(), trt.make_nlp("cpu")
    rng = np.random.default_rng(0)
    Z = trt.initial_guess() + 0.01 * rng.standard_normal((2, nt.n))
    NU = rng.standard_normal((2, nt.m))
    # gradient-based row scaling at the guess, as the IPM applies it
    J0 = np.asarray(jax.jit(jax.jacfwd(nj.constraints))(jnp.asarray(Z[0])))
    c_scale = np.minimum(1.0, 100.0 / np.maximum(np.abs(J0).max(1), 1e-8))
    c = dict(name=request.param, trj=trj, trt=trt, nj=nj, nt=nt, Z=Z,
             NU=NU, c_scale=c_scale,
             csj=_compiled(nj, jkkt.CompiledStructure),
             cst=_compiled(nt, CompiledStructure))
    c["jax"] = _jax_blocks(c)
    c["port"] = _port_blocks(c)
    return c


def _assert_same_index_arrays(a, b):
    assert (a.N, a.nv, a.nc, a.n, a.m) == (b.N, b.nv, b.nc, b.n, b.m)
    for name in ("V", "Vm", "C", "Cm", "bv", "bc"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)


def test_structure_matches_jax(case):
    sj, st = case["nj"].structure, case["nt"].structure
    assert st is not None
    assert st.var_blocks == sj.var_blocks
    assert st.con_blocks == sj.con_blocks
    np.testing.assert_array_equal(st.border_vars, sj.border_vars)
    np.testing.assert_array_equal(st.border_cons, sj.border_cons)
    _assert_same_index_arrays(case["cst"], case["csj"])
    free = _free_idx(case["nt"])
    assert len(free) < case["nt"].n  # the problems pin endpoint states
    _assert_same_index_arrays(case["cst"].remap_free(free),
                              case["csj"].remap_free(free))


def _jax_blocks(case):
    """The JAX package's blocks and row norms, lane by lane (jitted)."""
    nj, c_scale = case["nj"], jnp.asarray(case["c_scale"])
    c_fn = lambda zz: c_scale * nj.constraints(zz)  # noqa: E731
    bd = js.BlockDerivatives(case["csj"], c_fn, nj.objective)
    lag_grad = jax.grad(lambda zz, nn: nj.objective(zz) + c_fn(zz) @ nn)
    jac = jax.jit(bd.jac_blocks)
    hess = jax.jit(lambda z, nu: bd.hess_blocks(lag_grad, z, nu))
    bd.jac_blocks = jac  # jac_row_inf_norms calls it
    out = []
    for z, nu in zip(case["Z"], case["NU"]):
        z, nu = jnp.asarray(z), jnp.asarray(nu)
        out.append((jax.device_get(jac(z)), jax.device_get(hess(z, nu)),
                    bd.jac_row_inf_norms(z)))
    return out


def _port_blocks(case):
    nt = case["nt"]
    c_scale = torch.as_tensor(case["c_scale"])
    c_fn = lambda zz: c_scale * nt.constraints(zz)  # noqa: E731
    bd = ts.BlockDerivatives(case["cst"], c_fn, "cpu")

    def lag_grad(zz, nn):
        return grad(lambda q: (nt.objective(q) +
                               (c_fn(q) * nn).sum(-1)).sum())(zz)

    Z, NU = torch.as_tensor(case["Z"]), torch.as_tensor(case["NU"])
    return bd, bd.jac_blocks(Z), bd.hess_blocks(lag_grad, Z, NU)


def test_block_derivatives_match_jax(case):
    bd_t, jb_t, hb_t = case["port"]
    for lane, (jb_j, hb_j, norms_j) in enumerate(case["jax"]):
        for name in ("Jcv", "Jc0v1", "Jcb", "Jbc"):
            assert _rel(jb_t[name][lane], jb_j[name]) <= 1e-10, name
        for name in ("Hvv", "Hvb", "Hbb"):
            assert _rel(hb_t[name][lane], hb_j[name]) <= 1e-10, name
        norms_t = bd_t.jac_row_inf_norms(torch.as_tensor(case["Z"][lane]))
        assert _rel(norms_t, norms_j) <= 1e-10


def _kkt_inputs(case):
    rng = np.random.default_rng(1)
    nt = case["nt"]
    return dict(sigma=rng.uniform(0.5, 2.0, (2, nt.n)),
                r1=rng.standard_normal((2, nt.n)),
                r2=rng.standard_normal((2, nt.m)),
                delta_w=np.array([1e-3, 0.0]), delta_c=np.array([1e-8, 1e-6]))


def test_btb_matches_jax(case):
    bd_t, jb_t, hb_t = case["port"]
    ix = bd_t.ix
    inp = _kkt_inputs(case)
    t = {k: torch.as_tensor(v) for k, v in inp.items()}
    blocks_t = ts.assemble_kkt_blocks(hb_t, jb_t, t["sigma"], t["delta_w"],
                                      t["delta_c"], ix)
    fac = ts.btb_factor(*blocks_t)
    x, w = ts.btb_solve(fac, *ts.pack_rhs(t["r1"], t["r2"], ix))
    dz, dnu = ts.unpack_sol(x, w, ix)
    csj = case["csj"]
    for lane, (jb_j, hb_j, _) in enumerate(case["jax"]):
        blocks_j = js.assemble_kkt_blocks(
            hb_j, jb_j, jnp.asarray(inp["sigma"][lane]),
            inp["delta_w"][lane], inp["delta_c"][lane], csj)
        if blocks_j[2] is None:  # no border: the port keeps empty blocks
            blocks_j = blocks_j[:2]
        for bt, bj in zip(blocks_t, blocks_j):
            assert _rel(bt[lane], bj) <= 1e-12
        rT, rC = js.pack_rhs(jnp.asarray(inp["r1"][lane]),
                             jnp.asarray(inp["r2"][lane]), None, csj)
        xj, wj = js.btb_solve(js.btb_factor(*blocks_j), rT, rC)
        dz_j, dnu_j = js.unpack_sol(xj, wj, csj, jnp.float64)
        sol_t = torch.cat([dz[lane], dnu[lane]]).numpy()
        sol_j = np.concatenate([np.asarray(dz_j), np.asarray(dnu_j)])
        assert _rel(sol_t, sol_j) <= 1e-10
        # the assembled KKT, solved to a small residual
        H = js.blocks_to_dense_H(hb_j, csj) + np.diag(inp["sigma"][lane]) + \
            inp["delta_w"][lane] * np.eye(csj.n)
        J = js.blocks_to_dense_J(jb_j, csj)
        K = np.block([[H, J.T], [J, -inp["delta_c"][lane] *
                                 np.eye(csj.m)]])
        res = np.abs(K @ sol_t - np.concatenate(
            [inp["r1"][lane], inp["r2"][lane]])).max()
        assert res <= 1e-10 * max(np.abs(K).max() * np.abs(sol_t).max(), 1.0)


def test_helpers_match_dense_autodiff(case):
    """dense_J/H_from_blocks, block_H_matvec, block_H_diag and the
    pack/unpack permutation against dense ``torch.func`` derivatives."""
    nt = case["nt"]
    bd, jb, hb = case["port"]
    ix = bd.ix
    c_scale = torch.as_tensor(case["c_scale"])
    Z, NU = torch.as_tensor(case["Z"]), torch.as_tensor(case["NU"])
    J = ts.dense_J_from_blocks(jb, ix)
    H = ts.dense_H_from_blocks(hb, ix)
    v = torch.as_tensor(np.random.default_rng(2).standard_normal((2, nt.n)))
    for lane in range(2):
        z, nu = Z[lane], NU[lane]
        J_ref = jacfwd(lambda q: c_scale * nt.constraints(q))(z)
        H_ref = jacfwd(grad(lambda q: nt.objective(q) + (
            c_scale * nt.constraints(q) * nu).sum()))(z)
        assert _rel(J[lane], J_ref.numpy()) <= 1e-10
        assert _rel(H[lane], H_ref.numpy()) <= 1e-10
    assert _rel(ts.block_H_matvec(hb, ix, v),
                (H @ v[..., None])[..., 0].numpy()) <= 1e-12
    assert _rel(ts.block_H_diag(hb, ix),
                torch.diagonal(H, 0, -2, -1).numpy()) == 0.0
    r2 = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, nt.m)))
    rT, rC = ts.pack_rhs(v, r2, ix)
    assert rT.shape == (2, ix.N, ix.nb) and rC.shape == (2, ix.k)
    back = ts.unpack_sol(rT, rC, ix)
    assert torch.equal(back[0], v) and torch.equal(back[1], r2)


def test_kkt_structure_guards():
    """No structure (dense path) when a cost goal adds cross-block
    curvature, as in the JAX package; a structure for prescribed motion
    that holds every variable and every row once, the force balance's rows
    among them (``test_torch_prescribed.py`` holds its index arrays
    against the JAX package's)."""

    class EndpointProduct(Goal):
        def value(self, rep, initial, final, integral, p):
            return initial[1][..., 0] * final[1][..., 0]

    study = tex.sliding_mass_study(6, "trapezoidal")
    study.problem.add_goal(EndpointProduct(name="coupled"))
    assert study.transcription().kkt_structure() is None
    tr = tex.hanging_muscle_inverse(0.25).build_study().transcription()
    assert tr.prescribed
    st = tr.kkt_structure()
    nlp = tr.make_nlp("cpu")
    rows = sorted(sum(st.con_blocks, []) + list(st.border_cons))
    cols = sorted(sum(st.var_blocks, []) + list(st.border_vars))
    assert rows == list(range(nlp.m)) and cols == list(range(nlp.n))
    assert dict(tr.constraint_group_info())["dae_residual"] == tr.G * 2
