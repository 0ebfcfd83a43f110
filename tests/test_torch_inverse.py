"""The port's ``Inverse`` tool on the CPU, float64.

* The JAX package's two inverse solves (``tests/test_inverse.py:15-72``)
  through the port, with their own assertions: one actuator against a
  damper, whose control is the inverse dynamics, and a rigid-tendon muscle
  with a heavily weighted reserve that carries the load.
* The hanging-muscle inverse (``test_torch_inverse_common.py``, mesh
  interval 0.1) against the JAX package: ``init_fn`` and three
  ``body_fn`` steps under ``kkt="dense"`` (1e-6) and ``"structured"``
  (1e-5, ``test_torch_ipm_common.py`` explains why), with the tool's IPM
  options (``objective-only`` curvature, no control-midpoint rows, the
  implicit-derivative penalty); and both packages' ``Study.solve`` from
  the guess: both converge, objectives within relative 1e-3, controls
  within 1e-3.
* The kinematics as a ``StoTable``: written with ``write_sto``, read back
  with each package's ``read_sto``, the coordinates' columns found by
  name among others. The port's transcription equals its own from the
  ``(times, values)`` form and the JAX package's from its table, on the
  hanging muscle and on the arm with a coupler (whose stale dependent
  column the tool projects).
"""

import dataclasses

import numpy as np
import pytest
import torch

from opensim_moco_tpu.utils import tables as jtab

from opensim_moco_tpu_torch.models import MechModelBuilder
from opensim_moco_tpu_torch.models import muscle as dgf
from opensim_moco_tpu_torch.models.model import Model
from opensim_moco_tpu_torch.tools import Inverse
from opensim_moco_tpu_torch.utils import tables as ttab
from test_torch_constrained_common import (check_functions,
                                           check_iterate_parity,
                                           one_blas_thread, points)
from test_torch_inverse_common import inverses


def test_inverse_single_actuator_matches_inverse_dynamics():
    """One actuator: x(t) = m qdd + c qd for q(t) = 0.5 sin(t)."""
    m_val, c_val = 1.7, 0.8
    b = MechModelBuilder(gravity=(0.0, 0.0, 0.0))
    b.add_body("b", mass=m_val, joint_name="j", kind="prismatic",
               axis=(1, 0, 0), coord_name="q")
    model = Model(b.finalize())
    model.add_spring_generalized_force("damper", "q", viscosity=c_val)
    model.add_coordinate_actuator("act", "q", optimal_force=1.0,
                                  min_control=-100, max_control=100)
    times = np.linspace(0, 2.0, 101)
    qs = 0.5 * np.sin(times)[:, None]

    inv = Inverse(model=model, kinematics=(times, qs), mesh_interval=0.05,
                  convergence_tolerance=1e-6)
    sol = inv.solve("cpu")
    assert sol.success, sol.status
    t = sol.time
    expected = -m_val * 0.5 * np.sin(t) + c_val * 0.5 * np.cos(t)
    got = sol.control("/forceset/act")
    sl = slice(6, -6)  # the natural spline's end effects
    np.testing.assert_allclose(got[sl], expected[sl], atol=5e-3)


def test_inverse_muscle_plus_reserve():
    """A rigid-tendon muscle without activation dynamics and a weak,
    heavily weighted reserve: the muscle carries the load."""
    b = MechModelBuilder(gravity=(9.81, 0.0, 0.0))
    b.add_body("b", mass=1.0, joint_name="j", kind="prismatic",
               axis=(1, 0, 0), coord_name="h")
    model = Model(b.finalize())
    params = dgf.default_muscle_params(
        max_isometric_force=100.0, optimal_fiber_length=0.10,
        tendon_slack_length=0.05)
    model.add_muscle("muscle", path=[(-1, (0, 0, 0)), (0, (0, 0, 0))],
                     params=params, ignore_activation_dynamics=True,
                     ignore_tendon_compliance=True)
    model.add_coordinate_actuator("reserve", "h", optimal_force=1.0,
                                  min_control=-10, max_control=10)

    times = np.linspace(0, 1.0, 51)
    qs = (0.15 + 0.005 * np.sin(2 * np.pi * times))[:, None]
    inv = Inverse(model=model, kinematics=(times, qs), mesh_interval=0.05,
                  convergence_tolerance=1e-4, reserves_weight=10.0)
    sol = inv.solve("cpu")
    assert sol.success, sol.status
    act = sol.control("/forceset/muscle")
    res = sol.control("/forceset/reserve")
    assert np.all(act > 0.02)
    assert np.max(np.abs(res)) < 1.0
    assert 0.05 < np.mean(act) < 0.3


@pytest.fixture(scope="module")
def studies():
    ij, it = inverses("hanging", 0.1)
    return ij.build_study(), it.build_study()


def _tool_options(study, kkt):
    o = study.ipm_options
    return dict(tol=o.tol, max_iter=o.max_iter, mu_init=o.mu_init,
                hessian_approximation=o.hessian_approximation, kkt=kkt)


@pytest.mark.parametrize("kkt,rtol", [("dense", 1e-6),
                                      ("structured", 1e-5)])
def test_hanging_inverse_iterate_parity(studies, kkt, rtol):
    sj, st = studies
    opts = _tool_options(st, kkt)
    assert opts["hessian_approximation"] == "objective-only"
    assert not st.solver_options.interpolate_control_midpoints
    assert st.solver_options.minimize_implicit_auxiliary_derivatives
    check_iterate_parity(sj.transcription(), st.transcription(), opts, rtol)


def test_hanging_inverse_solve_matches_jax(studies):
    sj, st = studies
    with one_blas_thread():
        sol_j = sj.solve()
    sol_t = st.solve("cpu")
    assert sol_j.success and sol_t.success, (sol_j.status, sol_t.status)
    assert abs(sol_t.objective - sol_j.objective) <= \
        1e-3 * abs(sol_j.objective)
    np.testing.assert_allclose(sol_t.controls, np.asarray(sol_j.controls),
                               atol=1e-3)
    assert sol_t.control_names == list(sol_j.control_names)
    assert sol_t.state_names == list(sol_j.state_names) == [
        "/forceset/muscle/activation",
        "/forceset/muscle/normalized_tendon_force"]


@pytest.mark.parametrize("name", ["hanging", "arm_coupler"])
def test_inverse_from_sto_table(tmp_path, name):
    _, tuple_form = inverses(name, 0.1)
    ij, it = inverses(name, 0.1)
    times, values = it.kinematics
    paths = [f"{c}/value" for c in it.model.coordinate_paths()]
    # the coordinates in reverse order after a column the tool ignores
    cols = ["/forceset/unused"] + paths[::-1]
    data = np.column_stack([np.ones_like(times), values[:, ::-1]])
    path = str(tmp_path / "kinematics.sto")
    ttab.write_sto(path, ttab.StoTable(times, cols, data,
                                       {"inDegrees": "no"}))
    ij.kinematics, it.kinematics = jtab.read_sto(path), ttab.read_sto(path)

    trt = it.build_study().transcription()
    tr_tuple = tuple_form.build_study().transcription()
    nt, nu = trt.make_nlp("cpu"), tr_tuple.make_nlp("cpu")
    for z in points(trt):
        zt = torch.as_tensor(z)
        assert torch.equal(nt.constraints(zt), nu.constraints(zt))
        assert torch.equal(nt.objective(zt), nu.objective(zt))
    check_functions(ij.build_study().transcription(), trt)
