"""The walker's MocoInverse (``examples.walker2d_inverse_study``) against
the JAX package, float64 on the CPU, at 3 mesh intervals.

The JAX side is built step for step with its own classes: the wrapping
walker of ``example_models/walker2d.py`` without spheres, implicit
compliant tendons without passive fiber force, the leg's reserves, the
GRFs through the JAX package's ``ModOpAddExternalLoads`` from the same
XML and .mot, the 6 Hz low-passed reference through its ``Inverse``.

* ``prescribed_point_constants`` at the grid times (``tau_net`` with the
  external loads folded in, the moment arms R through the wraps and the
  moving and conditional points, lMT, vMT): relative 1e-12;
* layout, c(z), f(z) and the gradient of the Lagrangian at the guess and
  a jittered point, and the KKT structure: as
  ``test_torch_constrained_common.py`` (1e-12; structure exact).
The ``JointReactionGoal``'s value and compressed blocks are held on the
chain of ``test_torch_path_wrap_model.py``, whose reactions carry the same
wraps, moving and conditional points and external load: the JAX
package's Hessian blocks of that goal on this walker took 816 s to
compile on the CPU. ``chip_smoke.py`` phase 29 holds the goal on the
walker, card against CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opensim_moco_tpu import examples as _jex  # noqa: F401  (import order)
from opensim_moco_tpu.models import MechModelBuilder as JMechModelBuilder
from opensim_moco_tpu.models import muscle as jdgf
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu.models.wrap import WrapCylinderSpec as JWrap
from opensim_moco_tpu.tools import Inverse as JInverse
from opensim_moco_tpu.utils.processors import ModOpAddExternalLoads as JModOp
from opensim_moco_tpu.utils.processors import filter_lowpass as jlowpass
from opensim_moco_tpu.utils.splines import CubicSpline as JCubicSpline
from opensim_moco_tpu.utils.tables import StoTable as JStoTable
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.example_models import walker2d
from test_torch_constrained_common import (check_functions, check_layout,
                                           check_structure, per_lane, rel)

torch.set_num_threads(2)

T = walker2d.HALF_CYCLE
MESH = T / 3


def jax_inverse_model():
    """``examples.walker2d_inverse_model`` with the JAX package's
    classes."""
    return walker2d.build_inverse_walker(JMechModelBuilder, JModel,
                                         JCubicSpline, jdgf, JWrap, JModOp)


def jax_inverse_study(mesh_interval):
    t, q = walker2d.reference()
    kin = jlowpass(JStoTable(t, list(walker2d.COORDS), q), 6.0)
    return JInverse(model=jax_inverse_model(),
                    kinematics=(kin.time, kin.data), initial_time=0.0,
                    final_time=T, mesh_interval=mesh_interval,
                    convergence_tolerance=1e-3,
                    reserves_weight=walker2d.RESERVES_WEIGHT).build_study()


@pytest.fixture(scope="module")
def pair():
    """The two transcriptions, and the JAX package's point constants at the
    grid times from one jitted function, point by point (``per_lane``;
    its transcription computes them eagerly, about four times slower on
    this model): they become that transcription's cached constants, so
    that its c(z) reads them."""
    trj = jax_inverse_study(MESH).transcription()
    trt = tex.walker2d_inverse_study(MESH).transcription()
    mj = trj.rep.model
    pj = trj.rep.apply_parameters(jnp.zeros(0))
    cj = per_lane(lambda t: mj.prescribed_point_constants(pj, t))(
        jnp.asarray(np.asarray(trj.taus) * T))
    trj._presc_cache = jax.tree.map(np.asarray, jax.device_get(cj))
    return trj, trt


def test_layout(pair):
    trj, trt = pair
    assert trt.prescribed and trt.fold_prescribed
    assert trt.rep.control_names == trj.rep.control_names
    check_layout(trj, trt)


def test_point_constants(pair):
    trj, trt = pair
    cj = trj._presc_cache
    mt = trt.rep.model
    ct = mt.prescribed_point_constants(mt.default_params("cpu"),
                                       torch.as_tensor(cj["t"]))
    assert sorted(ct) == sorted(cj)
    for k in cj:
        assert rel(ct[k], cj[k]) <= 1e-12, k
    # the GRFs are in tau_net: the pelvis's vertical balance carries them
    weight = walker2d.TOTAL_MASS * -walker2d.GRAVITY[1]
    assert np.abs(cj["tau_net"][:, 2]).max() < 0.5 * weight


def test_constraints_lagrangian_structure(pair):
    """c(z), f(z) and grad L(z, nu) = grad f + J^T nu at two points, then
    the KKT structure (exactly)."""
    trj, trt = pair
    check_functions(trj, trt, np.random.default_rng(2).standard_normal(
        trt.make_nlp("cpu").m))
    check_structure(trj, trt)
