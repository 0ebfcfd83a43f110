from .mech import (GROUND, BodySpec, JointSpec, MechModel, MechModelBuilder,
                   StationSpec)

__all__ = [
    "GROUND", "BodySpec", "JointSpec", "MechModel", "MechModelBuilder",
    "StationSpec",
]
