"""OpenSim storage (.sto/.mot) tables: read and write.

Counterpart of the table part of ``opensim_moco_tpu.utils.tables``
(``StoTable`` ``:55``, ``read_sto`` ``:72``, ``write_sto`` ``:117``) in
pure Python and numpy: header ``key=value`` lines up to ``endheader``,
then a whitespace-separated table whose first column is time. Marker
(.trc) tables and the trajectory writers are not ported yet (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

import numpy as np


class StoTable:
    """Column table with string metadata (TimeSeriesTable analogue)."""

    def __init__(self, time, column_names, data, metadata=None):
        self.time = np.asarray(time, dtype=np.float64)
        self.column_names = list(column_names)
        self.data = np.asarray(data, dtype=np.float64)
        self.metadata = dict(metadata or {})
        assert self.data.shape == (len(self.time), len(self.column_names))

    def column(self, name):
        return self.data[:, self.column_names.index(name)]

    def in_degrees(self):
        return self.metadata.get("inDegrees", "no").strip().lower() == "yes"


def read_sto(path_or_buf) -> StoTable:
    """Parse a .sto/.mot file or an open text buffer: header keys until
    ``endheader`` (a bare first line is the table's name), then the column
    names and the rows."""
    if isinstance(path_or_buf, (str, bytes)):
        with open(path_or_buf, "r") as fh:
            text = fh.read()
    else:
        text = path_or_buf.read()
    lines = text.splitlines()
    meta = {}
    i = 0
    while i < len(lines):
        line = lines[i].strip()
        i += 1
        if line == "endheader":
            break
        if "=" in line:
            k, _, v = line.partition("=")
            meta[k.strip()] = v.strip()
        elif line:
            meta.setdefault("name", line)
    while i < len(lines) and not lines[i].strip():
        i += 1
    names = lines[i].split()
    rows = [[float(x) for x in line.split()]
            for line in lines[i + 1:] if line.strip()]
    arr = np.asarray(rows, dtype=np.float64)
    if arr.size == 0:
        arr = np.zeros((0, len(names)))
    return StoTable(arr[:, 0], names[1:], arr[:, 1:], meta)


def write_sto(path, table: StoTable, name="table") -> None:
    """Write ``table`` with its metadata, ``version=3`` unless given, the
    row and column counts, and every number to 17 significant digits."""
    with open(path, "w") as fh:
        fh.write(f"{table.metadata.get('name', name)}\n")
        for k, v in table.metadata.items():
            if k == "name":
                continue
            fh.write(f"{k}={v}\n")
        if "version" not in table.metadata:
            fh.write("version=3\n")
        fh.write(f"nRows={len(table.time)}\n")
        fh.write(f"nColumns={1 + len(table.column_names)}\n")
        fh.write("endheader\n")
        fh.write("time\t" + "\t".join(table.column_names) + "\n")
        for i, t in enumerate(table.time):
            row = "\t".join(f"{float(x):.17g}" for x in table.data[i])
            fh.write(f"{float(t):.17g}\t{row}\n")
