"""Models built in code for the examples and the tests.

Each module holds one model's data, its reference motion and its builders.
It imports neither ``opensim_moco_tpu`` nor ``opensim_moco_tpu_torch``,
only numpy and scipy: its builders take the package's classes as
arguments, so that both packages build the same problem from it.

* ``contact_leg``: a planar leg on two contact spheres, squatting;
* ``walker2d``: a planar 10-coordinate, 18-muscle walker with gait2d's
  names, over half a gait cycle.
"""
