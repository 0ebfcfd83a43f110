"""The planar contact leg (``contact_leg.py``: custom joints, smooth sphere
contact, DGF muscles and the three gait goals) at mesh 5, the port
against the JAX package, float64 on the CPU: the NLP's functions, its KKT
structure and its compressed derivative blocks. The IPM steps are in
``test_torch_contact_leg_ipm.py`` (a file of their own: the JAX package
compiles its kernel for this model in about three minutes).

Held: the layout, bounds and guesses (exactly); c(z), f(z) and the
gradient of the Lagrangian at the guess and a jittered point (relative
1e-12 of the largest magnitude); the KKT structure's index lists and
compiled index arrays (exactly), with the periodicity rows in the border;
the compressed J blocks and the H blocks of the objective, the curvature
the lane is solved with (objective-only, ``chip_smoke.py`` phase 17: the
contact forces of the GRF goal with their frozen contact points;
relative 1e-10). The constraints' curvature through custom joints and
contact is held on the models (``test_torch_custom_joint.py``,
``test_torch_contact.py``) and on the gait goals' problem
(``test_torch_gait_goals.py``).
"""

import numpy as np

from opensim_moco_tpu_torch.example_models import contact_leg
from opensim_moco_tpu import ocp as jocp
from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models import muscle as jdgf
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu.utils.splines import CubicSpline as JCubicSpline
from opensim_moco_tpu_torch.examples import contact_leg_study
from test_torch_constrained_common import (check_blocks, check_functions,
                                           check_layout, check_structure)

MESH = 5


def transcriptions():
    """The JAX package's and the port's transcriptions of the leg at MESH
    intervals, both from ``contact_leg.py``."""
    jm = contact_leg.build_leg(JMechModelBuilder, JModel, JCubicSpline, jdgf)
    trj = contact_leg.build_study(jocp, jm, MESH).transcription()
    return trj, contact_leg_study(MESH).transcription()


def test_contact_leg_functions_and_blocks_parity():
    trj, trt = transcriptions()
    assert trt.rep.state_names == trj.rep.state_names
    assert trt.rep.control_names == trj.rep.control_names
    check_layout(trj, trt)
    nt = trt.make_nlp("cpu")
    check_functions(trj, trt, np.random.default_rng(1).standard_normal(nt.m))
    check_structure(trj, trt)
    n_periodic = len(trt.rep.state_names) - 1
    assert list(nt.structure.border_cons) == list(
        range(nt.m - n_periodic, nt.m))
    check_blocks(trj, trt, objective_only=True)
