"""The planar walker's de-novo prediction
(``examples.walker2d_prediction_study``, ``example_models/walker2d.py``)
at mesh 3, the port against the JAX package, float64 on the CPU. The JAX
side is built step for step as the JAX package's
``gait2d_prediction_study`` (``examples.py:291``) builds gait2d's, from
its ``Problem``, ``AverageSpeedGoal(use_com=True)``,
``ControlGoal(exponent=3, divide_by_displacement=True)``,
``_gait2d_symmetry_goal`` and ``_gait2d_state_bounds``, on the same walker
built with the JAX package's classes.

Held: the goals, the symmetry pairs and the state bounds; the layout and
bounds (exactly); the warm start from the walker's reference motion over
the half cycle (a ``Trajectory`` of its coordinates and their speeds,
each package's ``guess_from_trajectory``, exactly); c(z), f(z) and the
gradient of the Lagrangian at that guess and at the cold bounds-midpoint
guess, where the displacement is zero (relative 1e-12 of the largest
magnitude; the JAX package's objective and its gradient taken eagerly,
see below); the constraint groups ``endpoint:symmetry`` and
``endpoint:speed``; and ``kkt_structure()`` None on both sides (the
effort over displacement couples every time block with the endpoints).
No IPM iterate of the JAX package: its compile of this model alone takes
minutes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu import ocp as jocp
from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models import muscle as jdgf
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu.utils import trajectory as jtraj
from opensim_moco_tpu.utils.splines import CubicSpline as JCubicSpline
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.example_models import walker2d
from opensim_moco_tpu_torch.utils import trajectory as ttraj
from test_torch_constrained_common import check_layout, rel

torch.set_num_threads(2)

MESH = 3


def jax_study(num_mesh_intervals):
    """The JAX package's counterpart of ``walker2d_prediction_study``."""
    model = walker2d.build_walker(JMechModelBuilder, JModel, JCubicSpline,
                                  jdgf)
    prob = jocp.Problem(model)
    prob.set_time_bounds(0, (0.4, 0.6))
    prob.add_goal(jex._gait2d_symmetry_goal(model))
    prob.add_goal(jocp.AverageSpeedGoal(name="speed", use_com=True,
                                        desired_speed=1.2,
                                        mode="endpoint_constraint"))
    prob.add_goal(jocp.ControlGoal(name="effort", weight=10.0, exponent=3,
                                   divide_by_displacement=True))
    jex._gait2d_state_bounds(prob)
    study = jocp.Study(prob)
    study.set_solver_options(transcription_scheme="hermite-simpson",
                             num_mesh_intervals=num_mesh_intervals)
    study.set_ipm_options(tol=1e-4, max_iter=1000,
                          hessian_approximation="objective-only")
    return study


def reference_trajectories():
    """The walker's reference motion as the port's ``Trajectory``
    (``examples.walker2d_reference_trajectory``) and as the JAX
    package's, with the same tables."""
    port = tex.walker2d_reference_trajectory()
    fields = [f.name for f in dataclasses.fields(ttraj.Trajectory)]
    return port, jtraj.Trajectory(**{f: getattr(port, f) for f in fields})


@pytest.fixture(scope="module")
def studies():
    return jax_study(MESH), tex.walker2d_prediction_study(MESH)


def test_prediction_goals_and_bounds(studies):
    sj, (st, guess) = studies
    assert guess is None
    gj = {g.name: g for g in sj.problem.goals}
    gt = {g.name: g for g in st.problem.goals}
    assert list(gt) == list(gj) == ["symmetry", "speed", "effort"]
    assert gt["symmetry"].state_pairs == gj["symmetry"].state_pairs
    assert gt["symmetry"].control_pairs == gj["symmetry"].control_pairs
    for name in ("speed", "effort"):
        fields = [f.name for f in dataclasses.fields(gj[name])]
        assert [getattr(gt[name], f) for f in fields] == \
            [getattr(gj[name], f) for f in fields]

    def infos(prob):
        return {name: dataclasses.astuple(info)
                for name, info in prob.state_infos.items()}

    assert infos(st.problem) == infos(sj.problem)
    assert st.ipm_options.hessian_approximation == "objective-only"


def test_prediction_functions_parity(studies):
    sj, (st, _) = studies
    trj, trt = sj.transcription(), st.transcription()
    assert trt.rep.state_names == trj.rep.state_names
    assert trt.rep.control_names == trj.rep.control_names
    check_layout(trj, trt)
    names = [n for n, _ in trt.constraint_group_info()]
    assert "endpoint:symmetry" in names and "endpoint:speed" in names
    assert trt.kkt_structure() is None and trj.kkt_structure() is None
    ref_t, ref_j = reference_trajectories()
    assert ref_t.initial_time == 0.0
    assert abs(ref_t.final_time - walker2d.HALF_CYCLE) < 1e-12
    warm = trt.guess_from_trajectory(ref_t)
    np.testing.assert_array_equal(warm, trj.guess_from_trajectory(ref_j))
    _, warm_from_example = tex.walker2d_prediction_study(MESH, guess=ref_t)
    np.testing.assert_array_equal(warm_from_example, warm)
    nj, nt = trj.make_nlp(), trt.make_nlp("cpu")
    assert nt.structure is None and (nt.n, nt.m) == (nj.n, nj.m)
    nu = np.random.default_rng(1).standard_normal(nt.m)
    @jax.jit
    def c_and_grad_j(z):
        """c(z) and the gradient of c(z) . nu, one compile."""
        c, pullback = jax.vjp(nj.constraints, z)
        return c, pullback(jnp.asarray(nu))[0]

    # f and its gradient eagerly: at the cold guess the displacement is
    # exactly 0 eagerly (as in the port), while under jit XLA's fusion
    # leaves about 6e-17 of it, which the effort's 1 / d^2 (d = 1e-8, the
    # smoothed norm) turns into gradient entries of 1e8
    f_and_grad_j = jax.value_and_grad(nj.objective)
    nut = torch.as_tensor(nu)
    for z in (warm, trt.initial_guess()):
        zt, zj = torch.as_tensor(z), jnp.asarray(z)
        c_j, grad_c_j = c_and_grad_j(zj)
        f_j, grad_f_j = f_and_grad_j(zj)
        assert rel(nt.constraints(zt), c_j) <= 1e-12
        assert rel(nt.objective(zt), f_j) <= 1e-12
        gt_ = torch.func.grad(lambda zz: nt.objective(zz) +
                              (nt.constraints(zz) * nut).sum())(zt)
        assert torch.isfinite(gt_).all()
        assert rel(gt_, grad_f_j + grad_c_j) <= 1e-12
