"""Parity of the port's three gait goals against the JAX package, float64
on the CPU: ``StateTrackingGoal``, ``PeriodicityGoal`` and
``ContactTrackingGoal``.

Model: a planar point mass (tx, ty; 50 kg) with a smooth sphere and an
AckermannVanDenBogert station, force actuators on both coordinates.
Inputs (grid times inside, outside and on the reference samples; states
and controls around contact; reference tables) are drawn with numpy from
a fixed seed.

Checked: each goal's integrand on a batch of grid points (the JAX
package's through ``vmap``), the periodicity rows and cost value at
endpoints, with every pair form of ``MocoPeriodicityGoal`` and the
negated speed pair of ``test_goals.py``; then, on a problem with the
three goals at mesh 4, c(z), f(z), the KKT structure (the periodicity
rows in the border) and the compressed J and H blocks, and that a
periodicity cost sends both packages to the dense KKT path. Tolerance:
relative 1e-12 of the largest magnitude for values, 1e-10 for the
blocks (``test_torch_constrained_common.py``).

The problem's points (the bounds midpoint and a jitter of it) hold the
sphere at the edge of contact. Far from it (5 cm above the ground at the
default smoothing of 300 / m) the Hertz gate 0.5 (1 + tanh) saturates,
and its second derivative is a difference of numbers near 1 that both
packages get wrong by about 1e-3 of its (tiny) value, each in its own way
(against 50-digit arithmetic): the objective's Hessian entries then
differ by 3.5e-8 of their size. That is rounding in float64, not a
different formula.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu import ocp as jocp
from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu_torch import ocp as tocp
from opensim_moco_tpu_torch.convert import params_from_numpy
from opensim_moco_tpu_torch.models import MechModelBuilder as TMechModelBuilder
from opensim_moco_tpu_torch.models.model import Model as TModel
from test_torch_constrained_common import (check_blocks, check_functions,
                                           check_structure, per_lane)

torch.set_num_threads(2)

RTOL = 1e-12
JAX = (JMechModelBuilder, JModel, jocp)
PORT = (TMechModelBuilder, TModel, tocp)
X, Y = "/jointset/tx/tx", "/jointset/ty/ty"


def assert_close(port, ref, rtol=RTOL):
    port = port.detach().numpy()
    ref = np.asarray(ref)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    scale = max(np.max(np.abs(ref)), 1e-300) if ref.size else 1.0
    np.testing.assert_allclose(port, ref, rtol=0, atol=rtol * scale)


def planar_mass(pkg):
    B, Model = pkg[:2]
    b = B(gravity=(0.0, -9.81, 0.0))
    b.add_body("ptx", mass=0.0, joint_name="tx", kind="prismatic",
               axis=(1, 0, 0), coord_name="tx")
    b.add_body("body", mass=50.0, parent="ptx", joint_name="ty",
               kind="prismatic", axis=(0, 1, 0), coord_name="ty")
    model = Model(b.finalize())
    model.add_sphere_contact("ball", 1, (0.0, 0.0, 0.0), radius=0.05)
    model.add_station_contact("point", body=1, location=(0.02, -0.04, 0.0),
                              stiffness=1e6)
    for c in ("tx", "ty"):
        model.add_coordinate_actuator(f"f{c}", c, optimal_force=100.0,
                                      min_control=-10, max_control=10)
    return model.finalize()


def _reference(rng):
    times = np.linspace(0.0, 1.0, 11)
    return {f"{X}/value": (times, 0.1 * rng.standard_normal(11)),
            f"{Y}/value": (times, 0.04 + 0.01 * rng.standard_normal(11)),
            f"{Y}/speed": (times, 0.2 * rng.standard_normal(11))}


def _grf(rng):
    times = np.linspace(0.0, 1.0, 9)
    forces = np.stack([30 * rng.standard_normal(9),
                       490 + 50 * rng.standard_normal(9),
                       5 * rng.standard_normal(9)], 1)
    return {"grf": (times, forces), "half": (times, 0.5 * forces)}


def goals(pkg, rng, projection="plane", periodicity_mode=None):
    g = pkg[2]
    ref, grf = _reference(rng), _grf(rng)
    out = [
        g.StateTrackingGoal(name="track", weight=3.0, reference=ref,
                            state_weights={f"{Y}/speed": 0.5}),
        g.ContactTrackingGoal(
            name="grf", weight=0.7,
            groups=((("ball", "point"), "grf"), (("ball",), "half")),
            reference=grf, projection=projection,
            projection_vector=(0.2, 0.1, 1.0)),
        g.ControlGoal(name="effort", weight=0.01)]
    if periodicity_mode:
        out.append(g.PeriodicityGoal(
            name="periodic", mode=periodicity_mode,
            state_pairs=(f"{Y}/value", (f"{Y}/speed", True)),
            control_pairs=(("/forceset/ftx", "/forceset/fty", False),)))
    return out


def reps(**kw):
    out = []
    for pkg in (JAX, PORT):
        pr = pkg[2].Problem(planar_mass(pkg))
        pr.set_time_bounds(0.0, 1.0)
        for goal in goals(pkg, np.random.default_rng(5), **kw):
            pr.add_goal(goal)
        out.append(pr.create_rep())
    return out


def _points(rng, G):
    t = np.concatenate([[-0.1, 0.0, 0.3, 1.0, 1.2],
                        rng.uniform(0.0, 1.0, G - 5)])
    y = np.stack([rng.uniform(-0.2, 0.2, G), rng.uniform(0.0, 0.06, G),
                  rng.standard_normal(G), rng.standard_normal(G)], 1)
    x = rng.uniform(-1.0, 1.0, (G, 2))
    return t, y, x


@pytest.mark.parametrize("projection", ["none", "vector", "plane"])
def test_tracking_integrands_parity(projection):
    rj, rt = reps(projection=projection)
    pj = rj.model.default_params()
    pt = params_from_numpy(jax.device_get(pj), "cpu")
    t, y, x = _points(np.random.default_rng(6), 12)
    lam = jnp.zeros(0)
    for gj, gt in zip(rj.goals[:2], rt.goals[:2]):
        ref = per_lane(lambda a, b, c, g=gj: g.integrand(
            rj, a, b, c, lam, pj))(*map(jnp.asarray, (t, y, x)))
        port = gt.integrand(rt, *map(torch.as_tensor, (t, y, x)),
                            torch.zeros(12, 0, dtype=torch.float64), pt)
        assert_close(port, ref)
    # the range-scaled form of the state tracking
    gj, gt = rj.goals[0], rt.goals[0]
    gj.scale_by_range = gt.scale_by_range = True
    ref = jax.vmap(lambda a, b: gj.integrand(rj, a, b, None, lam, pj))(
        jnp.asarray(t), jnp.asarray(y))
    assert_close(gt.integrand(rt, torch.as_tensor(t), torch.as_tensor(y),
                              None, None, pt), ref)


def test_periodicity_rows_parity():
    rj, rt = reps(periodicity_mode="endpoint_constraint")
    gj, gt = rj.goals[-1], rt.goals[-1]
    assert gt.num_outputs == gj.num_outputs == 3
    rng = np.random.default_rng(7)
    ends = [(rng.standard_normal((4, 4)), rng.standard_normal((4, 2)))
            for _ in range(2)]

    def endpoint(y, x, mod):
        return (mod.zeros(()), y, x, mod.zeros(0), mod.zeros(0))

    def jax_rows(y0, x0, yf, xf):
        a, b = endpoint(y0, x0, jnp), endpoint(yf, xf, jnp)
        return gj.values(rj, a, b, None), gj.value(rj, a, b, None, None)

    rows, cost = jax.vmap(jax_rows)(*map(jnp.asarray, sum(ends, ())))
    T = [torch.as_tensor(a) for a in sum(ends, ())]
    a, b = endpoint(*T[:2], torch), endpoint(*T[2:], torch)
    assert_close(gt.values(rt, a, b, None), rows)
    assert_close(gt.value(rt, a, b, None, None), cost)
    # the negated speed pair: u(T) + u(0)
    np.testing.assert_allclose(np.asarray(rows[:, 1]),
                               ends[1][0][:, 3] + ends[0][0][:, 3])


def _transcriptions(mode):
    out = []
    for pkg in (JAX, PORT):
        pr = pkg[2].Problem(planar_mass(pkg))
        pr.set_time_bounds(0.0, 1.0)
        pr.set_state_info(f"{X}/value", (-0.5, 0.5))
        pr.set_state_info(f"{Y}/value", (0.0, 0.1))
        for goal in goals(pkg, np.random.default_rng(5),
                          periodicity_mode=mode):
            pr.add_goal(goal)
        st = pkg[2].Study(pr)
        st.set_solver_options(num_mesh_intervals=4)
        out.append(st.transcription())
    return out


def test_gait_goals_transcription_parity():
    trj, trt = _transcriptions("endpoint_constraint")
    check_functions(trj, trt)
    check_structure(trj, trt)
    nlp = trt.make_nlp("cpu")  # the periodicity rows close c(z)
    assert list(nlp.structure.border_cons) == list(range(nlp.m - 3, nlp.m))
    check_blocks(trj, trt)
    trj, trt = _transcriptions("cost")
    check_functions(trj, trt)
    assert trj.kkt_structure() is None and trt.kkt_structure() is None
