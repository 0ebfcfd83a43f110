"""A two-link, six-muscle planar arm for inverse (prescribed-kinematics)
problems: the model's data and one builder that works with either
package's classes. Imports neither package, so the JAX package's tests,
the port's tests and ``chip_smoke.py`` build the same model from it.

The arm: two links of 0.3 m and 1.5 kg (centre of mass at mid-link, Izz =
m L^2 / 12) on revolute z joints ``q0`` (shoulder, at the ground origin)
and ``q1`` (elbow, 0.3 m down the first link), under gravity (0, -9.81,
0). Six DeGrooteFregly2016 muscles with activation dynamics and implicit
compliant tendons span fixed path points: a flexor and an extensor at the
shoulder, at the elbow, and across both joints. Each has F_max = 400 N,
l_opt = 0.55 l0 and l_slack = 0.45 l0, with l0 its path length at the
mean of the kinematics' samples, (q0, q1) = (0.3, 0.7960396). Reserves
(optimal force 1, controls in [-50, 50]) act on both coordinates. The
kinematics: q0 = 0.3 + 0.3 sin 2 pi t and q1 = 0.8 - 0.4 cos 2 pi t, 101
samples over [0, 1] s.
"""

import numpy as np

MASS = 1.5
LENGTH = 0.3
GRAVITY = (0.0, -9.81, 0.0)
F_MAX = 400.0
RESERVE_BOUND = 50.0
RESERVES_WEIGHT = 10.0

# (name, path): body -1 is ground, 0 the upper arm, 1 the forearm; local
# coordinates in metres
MUSCLES = (
    ("shoulder_flexor", ((-1, (0.06, 0.0, 0.0)), (0, (0.02, -0.12, 0.0)))),
    ("shoulder_extensor", ((-1, (-0.06, 0.0, 0.0)),
                           (0, (-0.02, -0.12, 0.0)))),
    ("elbow_flexor", ((0, (0.03, -0.10, 0.0)), (1, (0.02, -0.05, 0.0)))),
    ("elbow_extensor", ((0, (-0.03, -0.10, 0.0)), (1, (-0.02, 0.03, 0.0)))),
    ("biarticular_flexor", ((-1, (0.04, 0.02, 0.0)),
                            (1, (0.02, -0.06, 0.0)))),
    ("biarticular_extensor", ((-1, (-0.04, 0.02, 0.0)),
                              (1, (-0.02, 0.02, 0.0)))),
)
# path lengths at the samples' mean pose (the JAX package's
# ``Model.path_lengths``, to 8 digits)
L0 = (0.10886552, 0.14269787, 0.22156464, 0.19338177, 0.33520891,
      0.33125292)


def kinematics():
    """(times (K,), values (K, 2)) of the prescribed motion."""
    t = np.linspace(0.0, 1.0, 101)
    q0 = 0.3 + 0.3 * np.sin(2 * np.pi * t)
    q1 = 0.8 - 0.4 * np.cos(2 * np.pi * t)
    return t, np.stack([q0, q1], axis=1)


def build_arm(MechModelBuilder, Model, muscle):
    """The arm as a ``Model`` of the package whose ``MechModelBuilder``,
    ``Model`` and muscle module (``default_muscle_params``) are given;
    not finalized."""
    izz = MASS * LENGTH ** 2 / 12.0
    b = MechModelBuilder(gravity=GRAVITY)
    com = (0.0, -LENGTH / 2, 0.0)
    b.add_body("upper_arm", mass=MASS, com=com,
               inertia=np.diag([0.0, 0.0, izz]), joint_name="shoulder",
               kind="revolute", axis=(0, 0, 1), coord_name="q0")
    b.add_body("forearm", mass=MASS, com=com,
               inertia=np.diag([0.0, 0.0, izz]), parent="upper_arm",
               joint_name="elbow", kind="revolute", axis=(0, 0, 1),
               tree_r=(0.0, -LENGTH, 0.0), coord_name="q1")
    model = Model(b.finalize())
    for (name, path), l0 in zip(MUSCLES, L0):
        params = muscle.default_muscle_params(
            max_isometric_force=F_MAX, optimal_fiber_length=0.55 * l0,
            tendon_slack_length=0.45 * l0)
        model.add_muscle(name, path=list(path), params=params,
                         ignore_activation_dynamics=False,
                         ignore_tendon_compliance=False,
                         tendon_dynamics_implicit=True)
    for coord in ("q0", "q1"):
        model.add_coordinate_actuator(f"reserve_{coord}", coord,
                                      optimal_force=1.0,
                                      min_control=-RESERVE_BOUND,
                                      max_control=RESERVE_BOUND)
    return model
