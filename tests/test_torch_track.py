"""``MarkerTrackingGoal`` and the ``Track`` tool of the port
(``opensim_moco_tpu_torch/ocp/goals.py``, ``tools/track.py``) against the
JAX package's, float64 on the CPU, inputs drawn with numpy from fixed
seeds; each model built in both packages from the same builder here.

Held: the goal's integrand on the JAX test's planar point mass (exactly 0
on the reference, 0.04 within 1e-10 off it) and on seeded states
(1e-12); ``Track`` on the JAX test's point mass, states given as
``(times, dict)`` and as a ``StoTable`` low-passed with derived speeds:
the layout, bounds, mesh count, goal names and IPM options (equal),
``make_guess`` (1e-12), c(z), f(z) and the objective's gradient at that
guess (1e-10); the port's ``Track.solve`` on the CPU recovers the JAX
test's motion and control within that test's tolerances; a ``Track`` of
a two-link arm's markers (one marker blank in its first frames, which
moves the time window; one marker on no body): the layout, c(z), f(z)
and the gradient (1e-10), and the compressed J and objective H blocks
(1e-10); and the tool's ``ValueError``s."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu import ocp as jocp
from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu.tools import Track as JTrack
from opensim_moco_tpu.utils import tables as jtab
from opensim_moco_tpu_torch import ocp as tocp
from opensim_moco_tpu_torch.models import MechModelBuilder
from opensim_moco_tpu_torch.models.model import Model
from opensim_moco_tpu_torch.tools import Track
from opensim_moco_tpu_torch.utils import tables as ttab
from test_torch_constrained_common import check_blocks, check_layout, rel

PORT = (MechModelBuilder, Model, Track, ttab)
JAX = (JMechModelBuilder, JModel, JTrack, jtab)


def planar_point_mass(MB, M):
    """The JAX package's ``create_planar_point_mass``: x and y sliders,
    unit mass, force actuators."""
    b = MB(gravity=(0, -9.80665, 0))
    b.add_body("ptx", mass=0.0, joint_name="tx", kind="prismatic",
               axis=(1, 0, 0), coord_name="tx")
    b.add_body("body", mass=1.0, parent="ptx", joint_name="ty",
               kind="prismatic", axis=(0, 1, 0), coord_name="ty")
    model = M(b.finalize())
    model.add_coordinate_actuator("force_x", "tx", optimal_force=1.0)
    model.add_coordinate_actuator("force_y", "ty", optimal_force=1.0)
    return model.finalize()


def test_marker_goal_integrand():
    """``tests/test_goals.py``'s values, then seeded states and times."""
    times = np.linspace(0, 1, 5)
    ref = np.stack([times, np.zeros(5), np.zeros(5)], axis=1)
    kw = dict(markers={"m": (1, (0, 0, 0)), "n": (0, (0.1, -0.2, 0.3))},
              reference={"m": (times, ref),
                         "n": (times[1:], np.cos(ref[1:]) + 0.5)},
              marker_weights={"n": 2.5})
    jm, tm = planar_point_mass(JMechModelBuilder, JModel), \
        planar_point_mass(MechModelBuilder, Model)
    jrep, trep = jocp.Problem(jm).create_rep(), tocp.Problem(tm).create_rep()
    jp, tp = jm.default_params(), tm.default_params("cpu")
    one = tocp.MarkerTrackingGoal(markers={"m": kw["markers"]["m"]},
                                  reference={"m": (times, ref)})
    for q, want in ((0.5, 0.0), (0.7, 0.04)):
        f64 = dict(dtype=torch.float64)
        v = one.integrand(trep, torch.tensor(0.5, **f64),
                          torch.tensor([q, 0.0, 0.0, 0.0], **f64),
                          torch.zeros(2, **f64), torch.zeros(0, **f64), tp)
        if want == 0.0:
            assert float(v) == 0.0
        else:
            assert abs(float(v) - want) <= 1e-10 * want
    rng = np.random.default_rng(2)
    t = rng.uniform(-0.2, 1.2, 9)
    y = rng.standard_normal((9, 4))
    jg, tg = jocp.goals.MarkerTrackingGoal(**kw), \
        tocp.MarkerTrackingGoal(**kw)
    ref_v = jax.jit(jax.vmap(lambda tt, yy: jg.integrand(
        jrep, tt, yy, jnp.zeros(2), jnp.zeros(0), jp)))(jnp.asarray(t),
                                                        jnp.asarray(y))
    got = tg.integrand(trep, torch.as_tensor(t), torch.as_tensor(y),
                       torch.zeros(9, 2, dtype=torch.float64),
                       torch.zeros(9, 0, dtype=torch.float64), tp)
    assert rel(got, ref_v) <= 1e-12
    assert tg.hessian_block_local()


def slider(MB, M):
    """``tests/test_track.py``'s point mass on one slider."""
    b = MB(gravity=(0.0, 0.0, 0.0))
    b.add_body("b", mass=1.0, joint_name="j", kind="prismatic",
               axis=(1, 0, 0), coord_name="q")
    model = M(b.finalize())
    model.add_coordinate_actuator("act", "q", optimal_force=1.0,
                                  min_control=-10, max_control=10)
    return model.finalize()


W = 2 * np.pi
TIMES = np.linspace(0, 1.0, 101)
Q_REF = TIMES / W - np.sin(W * TIMES) / W ** 2
U_REF = (1 - np.cos(W * TIMES)) / W


def slider_track(pkg, form):
    MB, M, T, tab = pkg
    if form == "dict":
        ref = (TIMES, {"/jointset/j/q/value": Q_REF,
                       "/jointset/j/q/speed": U_REF})
        extra = {}
    else:  # a table with noise, a column off the model, speeds derived
        noise = 1e-3 * np.sin(2 * np.pi * 40 * TIMES)
        ref = tab.StoTable(TIMES, ["/jointset/j/q/value", "/forceset/x"],
                           np.stack([Q_REF + noise, TIMES], 1))
        extra = dict(lowpass_cutoff=6.0,
                     track_reference_position_derivatives=True)
    return T(model=slider(MB, M), states_reference=ref,
             states_global_weight=10.0, control_effort_weight=0.0001,
             mesh_interval=0.025, convergence_tolerance=1e-5, **extra)


def check_study(jtrack, ttrack):
    """The two tools' studies: layout, options and goal names equal,
    ``make_guess`` within 1e-12, and (returned) both transcriptions and
    the guess."""
    sj, st = jtrack.build_study(), ttrack.build_study()
    trj, trt = sj.transcription(), st.transcription()
    check_layout(trj, trt)
    assert st.solver_options.num_mesh_intervals == \
        sj.solver_options.num_mesh_intervals
    assert st.solver_options.transcription_scheme == \
        sj.solver_options.transcription_scheme == "hermite-simpson"
    assert dataclasses.asdict(st.ipm_options) == \
        dataclasses.asdict(sj.ipm_options)
    assert [g.name for g in st.problem.goals] == \
        [g.name for g in sj.problem.goals]
    gj, gt = jtrack.make_guess(sj), ttrack.make_guess(st)
    assert rel(gt, gj) <= 1e-12
    return trj, trt, gt


def check_at(trj, trt, z):
    """c(z), f(z) and the objective's gradient at z and at a jittered
    point within 1e-10 of the larger magnitude of the two points' (at a
    guess on the reference, f and its gradient vanish but for
    rounding)."""
    nj, nt = trj.make_nlp(), trt.make_nlp("cpu")
    fns = ((nt.constraints, jax.jit(nj.constraints)),
           (nt.objective, jax.jit(nj.objective)),
           (torch.func.grad(nt.objective), jax.jit(jax.grad(nj.objective))))
    lb, ub = trt.bounds()
    width = np.where(np.isfinite(ub - lb), ub - lb, 1.0)
    zj = np.clip(z + 0.05 * width * np.random.default_rng(4).uniform(
        -1, 1, z.shape), lb, ub)
    for port, ref in fns:
        pairs = [(port(torch.as_tensor(p)).numpy(), np.asarray(ref(p)))
                 for p in (z, zj)]
        scale = max(np.abs(r).max() for _, r in pairs)
        for got, want in pairs:
            assert np.abs(got - want).max() <= 1e-10 * scale


@pytest.mark.parametrize("form", ["dict", "table"])
def test_track_point_mass_parity(form):
    trj, trt, guess = check_study(slider_track(JAX, form),
                                  slider_track(PORT, form))
    assert trt.opt.num_mesh_intervals == 40
    assert (trt.bounds()[0][:2] == (0.0, 1.0)).all()
    check_at(trj, trt, guess)


def test_track_solve_recovers_motion():
    """The JAX test's recovery (``tests/test_track.py``), by the port on
    the CPU."""
    sol = slider_track(PORT, "dict").solve(device="cpu")
    assert sol.success, sol.status
    np.testing.assert_allclose(sol.state("/jointset/j/q/value"),
                               np.interp(sol.time, TIMES, Q_REF), atol=2e-3)
    u = sol.control("/forceset/act")
    np.testing.assert_allclose(u[3:-3], np.sin(W * sol.time)[3:-3],
                               atol=5e-2)


def two_link(MB, M):
    b = MB(gravity=(0, -9.81, 0))
    b.add_body("l1", mass=1.0, com=(0.5, 0, 0), inertia=(0.01, 0.1, 0.1),
               joint_name="j1", kind="revolute", axis=(0, 0, 1),
               coord_name="q1")
    b.add_body("l2", mass=0.7, com=(0.4, 0, 0), inertia=(0.01, 0.05, 0.05),
               parent="l1", joint_name="j2", kind="revolute",
               axis=(0, 0, 1), tree_r=(1.0, 0, 0), coord_name="q2")
    model = M(b.finalize())
    model.add_coordinate_actuator("t1", "q1", optimal_force=10.0)
    model.add_coordinate_actuator("t2", "q2", optimal_force=10.0)
    model.markers.update({"tip1": (0, (1.0, 0.0, 0.1)),
                          "tip2": (1, (0.8, 0.05, 0.0)),
                          "mid2": (1, (0.4, -0.03, -0.05))})
    return model.finalize()


def arm_markers(tab):
    """Marker positions of a swing q1 = 0.5 sin(2 pi t), q2 = 0.3 + t,
    41 frames: ``tip2`` blank in the first 3, ``plate`` on no body."""
    t = np.linspace(0.0, 0.8, 41)
    q1, q2 = 0.5 * np.sin(2 * np.pi * t), 0.3 + t
    e1 = np.stack([np.cos(q1), np.sin(q1)], 1)
    e12 = np.stack([np.cos(q1 + q2), np.sin(q1 + q2)], 1)
    n12 = np.stack([-np.sin(q1 + q2), np.cos(q1 + q2)], 1)
    pos = np.zeros((41, 4, 3))
    pos[:, 0, :2], pos[:, 0, 2] = e1, 0.1
    pos[:, 1, :2] = e1 + 0.8 * e12 + 0.05 * n12
    pos[:, 2, :2], pos[:, 2, 2] = e1 + 0.4 * e12 - 0.03 * n12, -0.05
    pos[:, 3] = (0.5, 0.5, 0.0)
    pos[:3, 1] = np.nan
    return tab.TrcTable(t, ["tip1", "tip2", "mid2", "plate"], pos,
                        {"Units": "m"})


def arm_track(pkg, **kw):
    MB, M, T, tab = pkg
    return T(model=two_link(MB, M), markers_reference=arm_markers(tab),
             markers_weights={"tip2": 3.0}, markers_global_weight=20.0,
             mesh_interval=0.08, **kw)


def test_track_markers_parity():
    jtrack, ttrack = (arm_track(pkg, allow_unused_references=True)
                      for pkg in (JAX, PORT))
    trj, trt, guess = check_study(jtrack, ttrack)
    # the window starts where tip2 does
    assert trt.bounds()[0][0] == pytest.approx(0.06, abs=1e-15)
    assert trt.opt.num_mesh_intervals == 10
    markers, reference, weights = ttrack._markers_dict()
    assert list(markers) == ["tip1", "tip2", "mid2"]
    assert len(reference["tip2"][0]) == 38 and weights == {"tip2": 3.0}
    check_at(trj, trt, guess)
    assert trt.make_nlp("cpu").structure is not None
    check_blocks(trj, trt, objective_only=True)


def test_track_errors():
    with pytest.raises(ValueError, match="requires"):
        Track(model=slider(MechModelBuilder, Model)).build_study()
    with pytest.raises(ValueError, match=r"absent from the model.*plate"):
        arm_track(PORT).build_study()
    st = arm_track(PORT, allow_unused_references=True).build_study()
    goal = st.problem.goals[0]
    assert goal.name == "marker_tracking" and "plate" not in goal.markers
