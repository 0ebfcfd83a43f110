"""A small model and the seven tracking and output goals of the port's
goal parity test (``test_torch_goals_tracking.py``) and of
``chip_smoke.py`` phase 26, for either package: each function takes that
package's ``MechModelBuilder``, ``Model`` and ``ocp`` module. Imports
neither package (numpy and the port's JAX-free ``example_models``).

The model: a 2 kg body on a custom joint with three rotations (about z,
x and y, so the orientation and angular-velocity goals are not planar)
and a forearm on a revolute joint about a tilted axis, a coordinate
actuator on each of the four coordinates, gravity (0.3, -9.81, 0.2). The
goals' reference tables are drawn with numpy from seed 0.
"""

import numpy as np

from opensim_moco_tpu_torch.example_models.contact_leg import Identity

COORDS = ("rz", "rx", "ry", "elbow")


def ball_arm(pkg):
    B, Model = pkg[:2]
    ident = Identity()
    b = B(gravity=(0.3, -9.81, 0.2))
    dirs = ((0, 0, 1), (1, 0, 0), (0, 1, 0), (1, 0, 0), (0, 1, 0), (0, 0, 1))
    axes = tuple((d, ident if k < 3 else None, k if k < 3 else 0)
                 for k, d in enumerate(dirs))
    b.add_body("upper", mass=2.0, com=(0.05, -0.3, 0.02),
               inertia=np.array([[0.05, 0.003, 0.0], [0.003, 0.02, 0.001],
                                 [0.0, 0.001, 0.06]]),
               kind="custom", joint_name="shoulder",
               coord_names=COORDS[:3], custom_axes=axes,
               tree_r=(0.0, 1.5, 0.0))
    axis = np.array([0.3, 0.1, 1.0])
    b.add_body("fore", mass=1.2, com=(0.0, -0.25, 0.01),
               inertia=np.diag([0.03, 0.01, 0.03]), parent="upper",
               joint_name="elbow", kind="revolute",
               axis=tuple(axis / np.linalg.norm(axis)),
               tree_r=(0.02, -0.6, 0.0), coord_name="elbow")
    model = Model(b.finalize())
    for c in COORDS:
        model.add_coordinate_actuator(f"a_{c}", c, optimal_force=20.0,
                                      min_control=-5, max_control=5)
    return model.finalize()


def _table(rng, k, *shape, scale=1.0):
    """Reference samples at k times around the window [0, 1]."""
    times = np.sort(rng.uniform(-0.1, 1.1, k))
    return times, scale * rng.normal(size=(k,) + shape)


def _rotations(rng, k):
    """k rotation matrices (QR of random matrices, det +1)."""
    mats = []
    for _ in range(k):
        qm, r = np.linalg.qr(rng.normal(size=(3, 3)))
        qm = qm * np.sign(np.diag(r))
        mats.append(qm * np.linalg.det(qm))
    return np.stack(mats)


def goals(pkg):
    """The eight goals, their reference tables drawn from seed 0 (the same
    for both packages)."""
    ocp = pkg[2]
    rng = np.random.default_rng(0)
    ctl = {"/forceset/a_rx": _table(rng, 9),
           "/forceset/a_elbow": _table(rng, 6)}
    trans = {0: _table(rng, 8, 3, scale=0.3), 1: _table(rng, 7, 3, scale=0.3)}
    times = np.sort(rng.uniform(-0.1, 1.1, 6))
    orient = {0: (times, _rotations(rng, 6)),
              1: (times[:5], _rotations(rng, 5))}
    omega = {0: _table(rng, 8, 3), 1: _table(rng, 5, 3)}
    acc = {0: _table(rng, 7, 3), 1: _table(rng, 9, 3)}

    def out(rep, t, y, x, lam, p):
        # the port's grid tensors or the JAX package's one point
        return y[..., 0] * x[..., 1] + 0.5 * t * y[..., 5]

    return [
        ocp.MarkerFinalGoal(name="marker_final", weight=3.0, body=1,
                            location=(0.01, -0.5, 0.02),
                            target=(0.2, 0.5, -0.1), squared=False),
        ocp.ControlTrackingGoal(name="control_tracking", reference=ctl,
                                control_weights={"/forceset/a_rx": 2.0}),
        ocp.TranslationTrackingGoal(name="translation", reference=trans),
        ocp.OrientationTrackingGoal(name="orientation", weight=0.5,
                                    reference=orient),
        ocp.AngularVelocityTrackingGoal(name="angular_velocity",
                                        weight=0.2, reference=omega),
        ocp.OutputGoal(name="output", output_fn=out, exponent=2),
        ocp.AccelerationTrackingGoal(name="acceleration", weight=1e-3,
                                     reference={1: acc[1]}),
        ocp.AccelerationTrackingGoal(name="acceleration_imu", weight=1e-3,
                                     reference={0: acc[0]},
                                     gravity_offset=True),
    ]


def problem(pkg, num_mesh_intervals=4):
    ocp = pkg[2]
    model = ball_arm(pkg)
    prob = ocp.Problem(model)
    prob.set_time_bounds(0.0, (0.8, 1.2))
    for path in model.coordinate_paths():
        prob.set_state_info(f"{path}/value", (-1.5, 1.5))
        prob.set_state_info(f"{path}/speed", (-8.0, 8.0))
    for g in goals(pkg):
        prob.add_goal(g)
    study = ocp.Study(prob)
    study.set_solver_options(num_mesh_intervals=num_mesh_intervals)
    return study.transcription()
