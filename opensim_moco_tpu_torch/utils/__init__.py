"""Host-side utilities of the port: splines evaluated on tensors, .sto
and .trc table I/O, the table processors, the ExternalLoads reader and its
model operator (numpy and scipy, no ``jax``)."""

from .osim import parse_external_loads
from .processors import (ModOpAddExternalLoads, TableProcessor,
                         TabOpConvertDegreesToRadians, TabOpLowPassFilter,
                         convert_degrees_to_radians, filter_lowpass,
                         resample_table)
from .splines import CubicSpline, QuinticSpline
from .tables import StoTable, TrcTable, read_sto, read_trc, write_sto

__all__ = ["CubicSpline", "QuinticSpline", "StoTable", "TrcTable",
           "read_sto", "read_trc", "write_sto", "TableProcessor",
           "TabOpConvertDegreesToRadians", "TabOpLowPassFilter",
           "convert_degrees_to_radians", "filter_lowpass", "resample_table",
           "ModOpAddExternalLoads", "parse_external_loads"]
