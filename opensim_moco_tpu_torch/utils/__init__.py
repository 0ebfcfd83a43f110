"""Host-side utilities of the port: splines evaluated on tensors and
.sto table I/O (numpy only, no ``jax``)."""

from .splines import CubicSpline, QuinticSpline
from .tables import StoTable, read_sto, write_sto

__all__ = ["CubicSpline", "QuinticSpline", "StoTable", "read_sto",
           "write_sto"]
