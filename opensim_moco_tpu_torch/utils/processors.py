"""Table processing before a tool consumes a table.

Counterpart of the table half of ``opensim_moco_tpu.utils.processors``
(``:19-80``; the reference's TableProcessor and TabOps), numpy and scipy
only: a ``TableProcessor`` holds a :class:`StoTable` and a chain of
operations joined with ``|``, each a callable from table to table.

The model operators (``ModelProcessor`` and the ModOps, JAX
``processors.py:85-299``) act on external loads and ``.osim`` models,
which the port does not have yet; they wait for ROADMAP.md queue 1
items 4 and 9.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from .tables import StoTable, read_sto


def filter_lowpass(table: StoTable, cutoff_hz: float,
                   order: int = 3) -> StoTable:
    """Zero-phase Butterworth low-pass of every column: a 3rd-order filter
    run forward and backward (``filtfilt``) at the normalized cutoff
    ``min(0.999, 2 cutoff mean(dt))``."""
    from scipy.signal import butter, filtfilt

    wn = min(0.999, 2.0 * cutoff_hz * np.mean(np.diff(table.time)))
    b, a = butter(order, wn)
    return StoTable(table.time, table.column_names,
                    filtfilt(b, a, table.data, axis=0), table.metadata)


def convert_degrees_to_radians(table: StoTable) -> StoTable:
    """A table with ``inDegrees=yes`` in radians (and ``inDegrees=no``);
    any other table as it is."""
    if not table.in_degrees():
        return table
    meta = dict(table.metadata)
    meta["inDegrees"] = "no"
    return StoTable(table.time, table.column_names, np.deg2rad(table.data),
                    meta)


def resample_table(table: StoTable, new_time) -> StoTable:
    """Every column interpolated linearly at ``new_time``."""
    new_time = np.asarray(new_time)
    data = np.stack([np.interp(new_time, table.time, table.data[:, j])
                     for j in range(table.data.shape[1])], axis=1)
    return StoTable(new_time, table.column_names, data, table.metadata)


class TableProcessor:
    """``TableProcessor(table_or_path) | op | op ...``; :meth:`process`
    applies the operations in order."""

    def __init__(self, table_or_path):
        self.table = (read_sto(table_or_path)
                      if isinstance(table_or_path, str) else table_or_path)
        self.ops: list[Callable] = []

    def __or__(self, op: Callable) -> "TableProcessor":
        out = TableProcessor(self.table)
        out.ops = self.ops + [op]
        return out

    def process(self) -> StoTable:
        t = self.table
        for op in self.ops:
            t = op(t)
        return t


def TabOpLowPassFilter(cutoff_hz):
    return lambda t: filter_lowpass(t, cutoff_hz)


def TabOpConvertDegreesToRadians():
    return convert_degrees_to_radians
