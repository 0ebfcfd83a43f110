"""Parity of the port's diagnostics against the JAX package, float64 on
the CPU: ``Transcription.objective_breakdown`` and ``constraint_report``,
``Study.objective_breakdown``, ``print_constraint_values`` and
``analyze``.

Problem: the double-pendulum swing-up at mesh 6 with its elbow path
constraint (a slack per mesh point), and added to it in both packages a
final-time cost, a sum-of-squared-states cost, a periodicity goal as a
cost and one as an endpoint constraint: four cost goals, a path
constraint and an endpoint-constraint goal. The iterate is the bounds
guess jittered with numpy from a fixed seed.

Held: each goal's weighted cost term within 1e-10 of the JAX package's
(relative to the largest), their sum equal to ``objective_fn`` (1e-12);
the constraint groups' names equal and each group's max |violation|
within 1e-10; ``analyze``'s table (a scalar and a vector output, each
written in its package's convention: one point in the JAX package, the
grid's tensors in the port's ``OutputGoal`` convention) with the same
columns and times and values within 1e-12.
"""

import types

import jax.numpy as jnp
import numpy as np
import torch

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu import ocp as jocp
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch import ocp as tocp
from test_torch_constrained_common import one_blas_thread, points

SPEED0 = "/jointset/j0/q0/speed"


def studies():
    out = []
    for ex, ocp in ((jex, jocp), (tex, tocp)):
        st = ex.double_pendulum_swingup_study(6, with_path_constraint=True)
        pr = st.problem
        pr.add_goal(ocp.FinalTimeGoal(name="time", weight=0.5))
        pr.add_goal(ocp.SumSquaredStateGoal(name="speeds", weight=0.01,
                                            pattern=".*speed"))
        pr.add_goal(ocp.PeriodicityGoal(
            name="periodic_cost", mode="cost", weight=2.0,
            state_pairs=(("/jointset/j1/q1/value", False),)))
        pr.add_goal(ocp.PeriodicityGoal(name="periodic_speed",
                                        state_pairs=((SPEED0, True),)))
        out.append(st)
    return out


def test_breakdown_and_constraint_report_match_jax():
    sj, st = studies()
    trj, trt = sj.transcription(), st.transcription()
    z = points(trt, seed=5)[1]
    with one_blas_thread():
        bj = trj.objective_breakdown(jnp.asarray(z))
        cj = trj.constraint_report(z)
    bt = trt.objective_breakdown(z, device="cpu")
    assert list(bt) == list(bj) == ["effort", "time", "speeds",
                                    "periodic_cost"]
    scale = max(abs(v) for v in bj.values())
    assert max(abs(bt[k] - bj[k]) for k in bj) <= 1e-10 * scale
    f = float(trt.objective_fn("cpu")(torch.as_tensor(z)))
    assert abs(sum(bt.values()) - f) <= 1e-12 * abs(f)
    ct = trt.constraint_report(z, device="cpu")
    assert list(ct) == list(cj)
    assert "path:elbow_range" in ct and "endpoint:periodic_speed" in ct
    scale = max(cj.values())
    assert max(abs(ct[k] - cj[k]) for k in cj) <= 1e-10 * scale
    # the Study's entry points read a solution's flat iterate
    sol = types.SimpleNamespace(raw_iterate=z)
    assert st.objective_breakdown(sol, device="cpu") == bt
    assert st.print_constraint_values(sol, device="cpu") == ct


def test_analyze_matches_jax():
    sj, st = studies()
    trt = st.transcription()
    nq = trt.rep.model.nq
    z = points(trt, seed=6)[1]
    sol = types.SimpleNamespace(raw_iterate=z)
    with one_blas_thread():
        tj = sj.analyze(sol, {
            "kinetic": lambda rep, t, y, x, lam, p:
                0.5 * jnp.sum(y[nq:2 * nq] ** 2) + t,
            "control": lambda rep, t, y, x, lam, p: x})
    tt = st.analyze(sol, {
        "kinetic": lambda rep, t, y, x, lam, p:
            0.5 * (y[..., nq:2 * nq] ** 2).sum(-1) + t,
        "control": lambda rep, t, y, x, lam, p: x}, device="cpu")
    assert tt.column_names == tj.column_names == ["kinetic", "control_0",
                                                  "control_1"]
    np.testing.assert_array_equal(tt.time, tj.time)
    assert np.abs(tt.data - tj.data).max() <= 1e-12 * np.abs(tj.data).max()
    assert tt.metadata == tj.metadata
