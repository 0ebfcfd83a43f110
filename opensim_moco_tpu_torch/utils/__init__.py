"""Utilities of the port: splines evaluated on tensors, .sto and .trc
table I/O and the .sto solution files, the table processors, the
ExternalLoads reader and its model operator (numpy and scipy), and the
forward time-stepping rollout (tensors on a device); no ``jax``."""

from .osim import parse_external_loads
from .processors import (ModOpAddExternalLoads, TableProcessor,
                         TabOpConvertDegreesToRadians, TabOpLowPassFilter,
                         convert_degrees_to_radians, filter_lowpass,
                         resample_table)
from .rollout import rollout, time_stepping_guess
from .splines import CubicSpline, QuinticSpline
from .tables import (StoTable, TrcTable, read_sto, read_trc,
                     sto_to_trajectory, trajectory_to_sto, write_sto)

__all__ = ["CubicSpline", "QuinticSpline", "StoTable", "TrcTable",
           "read_sto", "read_trc", "write_sto", "trajectory_to_sto",
           "sto_to_trajectory", "rollout", "time_stepping_guess",
           "TableProcessor",
           "TabOpConvertDegreesToRadians", "TabOpLowPassFilter",
           "convert_degrees_to_radians", "filter_lowpass", "resample_table",
           "ModOpAddExternalLoads", "parse_external_loads"]
