"""The planar walker's ``Track`` study (``examples.walker2d_track_study``,
``example_models/walker2d.py``) at mesh 3, the port against the JAX
package, float64 on the CPU. The JAX side is built step for step as the
port's study, through the JAX package's ``Track``, its
``_gait2d_symmetry_goal``, ``ContactTrackingGoal`` and
``_gait2d_state_bounds`` (the helpers of its ``gait2d_tracking_study``),
on the same walker built with the JAX package's classes.

Held: the symmetry goal's pairs and the state bounds (exactly); the
layout, bounds and the ``Track`` guess (exactly); c(z), f(z) and the
gradient of the Lagrangian at the guess and a jittered point (relative
1e-12 of the largest magnitude); the KKT structure's index lists and
compiled index arrays (exactly), with the 38 symmetry rows in the border;
the model's parameters carried across by ``convert.params_from_numpy``
(exactly). The compressed J and H blocks are held against the port's own
dense derivatives in ``test_torch_walker2d.py`` (the JAX package's block
derivatives of this model take minutes to compile).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models import muscle as jdgf
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu.ocp import ContactTrackingGoal as JContactTrackingGoal
from opensim_moco_tpu.tools.track import Track as JTrack
from opensim_moco_tpu.utils.splines import CubicSpline as JCubicSpline
from opensim_moco_tpu.utils.tables import StoTable as JStoTable
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.convert import params_from_numpy
from opensim_moco_tpu_torch.example_models import walker2d
from test_torch_constrained_common import (check_functions, check_layout,
                                           check_structure)

MESH = 3


def jax_study(num_mesh_intervals):
    """The JAX package's counterpart of ``walker2d_track_study``."""
    model = walker2d.build_walker(JMechModelBuilder, JModel, JCubicSpline,
                                  jdgf)
    t, q = walker2d.reference()
    ref = JStoTable(t, [f"{walker2d.coordinate_path(c)}/value"
                        for c in walker2d.COORDS], q)
    tf = walker2d.HALF_CYCLE
    track = JTrack(model=model, states_reference=ref,
                   states_global_weight=10.0, control_effort_weight=10.0,
                   track_reference_position_derivatives=True,
                   initial_time=0.0, final_time=tf,
                   mesh_interval=tf / num_mesh_intervals,
                   convergence_tolerance=1e-4, lowpass_cutoff=6.0)
    study = track.build_study()
    prob = study.problem
    prob.add_goal(jex._gait2d_symmetry_goal(model))
    prob.add_goal(JContactTrackingGoal(
        name="contact", weight=1.0,
        groups=((("contactHeel_r", "contactFront_r"), "Right_GRF"),
                (("contactHeel_l", "contactFront_l"), "Left_GRF")),
        reference=walker2d.grf_reference(),
        projection="plane", projection_vector=(0.0, 0.0, 1.0)))
    jex._gait2d_state_bounds(prob)
    return study, track.make_guess(study)


@pytest.fixture(scope="module")
def studies():
    return jax_study(MESH), tex.walker2d_track_study(MESH)


def test_symmetry_pairs_and_bounds(studies):
    (sj, _), (st, _) = studies
    gj = {g.name: g for g in sj.problem.goals}
    gt = {g.name: g for g in st.problem.goals}
    assert list(gt) == list(gj) == ["state_tracking", "control_effort",
                                    "symmetry", "contact"]
    assert gt["symmetry"].state_pairs == gj["symmetry"].state_pairs
    assert gt["symmetry"].control_pairs == gj["symmetry"].control_pairs
    assert gt["symmetry"].num_outputs == 38

    def infos(prob):
        return {name: dataclasses.astuple(info)
                for name, info in prob.state_infos.items()}

    assert infos(st.problem) == infos(sj.problem)


def test_walker_params(studies):
    """The JAX model's parameters carried into the port by
    ``params_from_numpy`` equal the port model's own."""
    (sj, _), (st, _) = studies
    carried = params_from_numpy(
        jax.device_get(sj.problem.model.default_params()), "cpu")
    own = st.problem.model.default_params("cpu")

    def walk(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for key in a:
                walk(a[key], b[key])
        else:
            assert a.dtype == b.dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)

    walk(carried, own)


def test_walker_functions_and_structure_parity(studies):
    (sj, gj), (st, gt) = studies
    trj, trt = sj.transcription(), st.transcription()
    assert trt.rep.state_names == trj.rep.state_names
    assert trt.rep.control_names == trj.rep.control_names
    np.testing.assert_array_equal(gt, np.asarray(gj))
    check_layout(trj, trt)
    nt = trt.make_nlp("cpu")
    check_functions(trj, trt, np.random.default_rng(1).standard_normal(nt.m))
    check_structure(trj, trt)
    assert list(nt.structure.border_cons) == list(range(nt.m - 38, nt.m))
