"""Shared builders of the inverse (prescribed-kinematics) parity tests
(``test_torch_prescribed.py``, ``test_torch_inverse.py``,
``test_torch_inverse_arm.py``): each problem as an ``Inverse`` of the JAX
package and of the port, on the same kinematics. No tests of its own.

* ``hanging``: the hanging muscle's body and muscle with activation
  dynamics and an implicit compliant tendon, plus a reserve (the port's
  ``examples.hanging_muscle_inverse``);
* ``arm``: the two-link, six-muscle arm of ``inverse_arm.py``;
* ``arm_coupler``: the arm with q1 = 0.8 + 0.5 (q0 - 0.3) as a coordinate
  coupler, so that the prescribed problem carries a multiplier, and the
  tool projects the dependent column of the kinematics onto it;
* ``hanging_activation_effort``: ``hanging`` with
  ``minimize_sum_squared_activations`` (``SumSquaredStateGoal``).
"""

import numpy as np

import inverse_arm
from opensim_moco_tpu.models import MechModelBuilder as JBuilder
from opensim_moco_tpu.models import muscle as jdgf
from opensim_moco_tpu.models.model import Model as JModel
from opensim_moco_tpu.tools import Inverse as JInverse
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.models import MechModelBuilder as TBuilder
from opensim_moco_tpu_torch.models import muscle as tdgf
from opensim_moco_tpu_torch.models.model import Model as TModel
from opensim_moco_tpu_torch.tools import Inverse as TInverse


def jax_hanging_inverse(mesh_interval):
    """The JAX package's counterpart of ``examples.hanging_muscle_inverse``."""
    b = JBuilder(gravity=(9.81, 0.0, 0.0))
    b.add_body("body", mass=0.5, joint_name="joint", kind="prismatic",
               axis=(1, 0, 0), coord_name="height")
    model = JModel(b.finalize())
    params = jdgf.default_muscle_params(
        max_isometric_force=30.0, optimal_fiber_length=0.10,
        tendon_slack_length=0.05, pennation_angle_at_optimal=0.1,
        fiber_damping=0.01, tendon_strain_at_one_norm_force=0.10,
        max_contraction_velocity=10.0)
    model.add_muscle("muscle", path=[(-1, (0.0, 0.0, 0.0)),
                                     (0, (0.0, 0.0, 0.0))],
                     params=params, ignore_activation_dynamics=False,
                     ignore_tendon_compliance=False,
                     tendon_dynamics_implicit=True)
    model.add_coordinate_actuator("reserve", "height", optimal_force=1.0,
                                  min_control=-10, max_control=10)
    times = np.linspace(0.0, 1.0, 101)
    q = 0.145 + 0.005 * np.cos(2 * np.pi * times)
    return JInverse(model=model, kinematics=(times, q[:, None]),
                    mesh_interval=mesh_interval, reserves_weight=10.0)


def _coupler(v):
    return 0.8 + 0.5 * (v - 0.3)


def arm_inverse(package, mesh_interval, coupler=False):
    """The arm's ``Inverse`` of ``package`` ("jax" or "torch")."""
    classes = ((JBuilder, JModel, jdgf, JInverse) if package == "jax"
               else (TBuilder, TModel, tdgf, TInverse))
    model = inverse_arm.build_arm(*classes[:3])
    if coupler:
        model.add_coordinate_coupler_constraint("coupler", "q1", "q0",
                                                _coupler)
    return classes[3](model=model, kinematics=inverse_arm.kinematics(),
                      mesh_interval=mesh_interval,
                      reserves_weight=inverse_arm.RESERVES_WEIGHT)


def inverses(name, mesh_interval):
    """(JAX Inverse, port Inverse) of one problem."""
    if name.startswith("hanging"):
        pair = (jax_hanging_inverse(mesh_interval),
                tex.hanging_muscle_inverse(mesh_interval))
        for inv in pair:
            inv.minimize_sum_squared_activations = \
                name == "hanging_activation_effort"
        return pair
    coupler = name == "arm_coupler"
    return (arm_inverse("jax", mesh_interval, coupler),
            arm_inverse("torch", mesh_interval, coupler))


def transcriptions(name, mesh_interval):
    """(JAX Transcription, port Transcription) of one problem's study."""
    ij, it = inverses(name, mesh_interval)
    return ij.build_study().transcription(), it.build_study().transcription()
