"""OpenSim storage (.sto/.mot) and marker (.trc) tables.

Counterpart of the table part of ``opensim_moco_tpu.utils.tables``
(``StoTable`` ``:55``, ``read_sto`` ``:72``, ``write_sto`` ``:117``,
``trajectory_to_sto`` ``:135``, ``sto_to_trajectory`` ``:183``,
``TrcTable`` ``:213``, ``read_trc`` ``:230``) in pure Python and numpy:
a .sto has header ``key=value`` lines up to ``endheader``, then a
whitespace-separated table whose first column is time; a .trc has three
header lines, a marker-name row, a component row and tab-separated
frames.
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


def trajectory_to_sto(traj, path):
    """Write a ``Trajectory``/``Solution`` in the reference's solution
    layout (MocoTrajectory::write): the state, control, multiplier and
    derivative columns in that order, and, for a ``Solution``, the solver's
    statistics in the header. Multipliers are negated on write (and again
    on read by :func:`sto_to_trajectory`): the reference applies constraint
    forces from -lambda where this package's residual uses +G^T lambda, so
    the files agree with the reference's."""
    cols = []
    names = []
    for group_names, data in [
            (traj.state_names, traj.states),
            (traj.control_names, traj.controls),
            (traj.multiplier_names, traj.multipliers),
            (traj.derivative_names, traj.derivatives)]:
        if data is None or not len(group_names):
            continue
        names += list(group_names)
        data = np.asarray(data)
        if group_names is traj.multiplier_names:
            data = -data
        cols.append(data)
    data = np.concatenate(cols, axis=1) if cols else np.zeros(
        (len(traj.time), 0))
    meta = {"name": "MocoSolution", "DataType": "double",
            "inDegrees": "no",
            "num_states": str(len(traj.state_names)),
            "num_controls": str(len(traj.control_names)),
            "num_multipliers": str(len(traj.multiplier_names)),
            "num_derivatives": str(len(traj.derivative_names)),
            "num_parameters": str(len(traj.parameter_names))}
    success = getattr(traj, "success", None)
    if success is not None:
        meta["success"] = "true" if success else "false"
        meta["objective"] = \
            f"{float(getattr(traj, 'objective', float('nan'))):.17g}"
        meta["num_iterations"] = str(getattr(traj, "num_iterations", -1))
        meta["solver_duration"] = \
            f"{float(getattr(traj, 'solver_duration', float('nan'))):.17g}"
        meta["status"] = str(getattr(traj, "status", ""))
    write_sto(path, StoTable(traj.time, names, data, meta))


def sto_to_trajectory(path):
    """A solution or trajectory .sto as a ``Solution``. Columns are sorted
    by their names: ``.../value``, ``.../speed``, ``.../activation`` and
    ``.../normalized_tendon_force`` are states; ``lambda...`` and
    ``.../multiplier...`` multipliers (negated, see
    :func:`trajectory_to_sto`); ``.../accel``, ``...implicitderiv...`` and
    ``..._derivative`` derivatives; every other column a control. The
    header gives ``success``, ``objective`` and ``status``."""
    from .trajectory import Solution

    t = read_sto(path)
    state_names, controls_names, mult_names, deriv_names = [], [], [], []
    for n in t.column_names:
        if (n.endswith("/value") or n.endswith("/speed") or
                n.endswith("/activation") or
                n.endswith("/normalized_tendon_force")):
            state_names.append(n)
        elif n.startswith("lambda") or "/multiplier" in n:
            mult_names.append(n)
        elif (n.endswith("/accel") or "implicitderiv" in n or
              n.endswith("_derivative")):
            deriv_names.append(n)
        else:
            controls_names.append(n)

    def pick(ns):
        return (np.stack([t.column(n) for n in ns], axis=1)
                if ns else np.zeros((len(t.time), 0)))

    meta = t.metadata
    return Solution(
        time=t.time,
        state_names=state_names, states=pick(state_names),
        control_names=controls_names, controls=pick(controls_names),
        multiplier_names=mult_names, multipliers=-pick(mult_names),
        derivative_names=deriv_names, derivatives=pick(deriv_names),
        success=meta.get("success", "true") == "true",
        objective=float(meta.get("objective", "nan")),
        status=meta.get("status", ""),
    )


class TrcTable:
    """Marker trajectories from a .trc file: ``time`` (K,),
    ``marker_names`` and ``positions`` (K, M, 3) in metres, NaN where a
    marker is missing (JAX ``utils/tables.py:213``)."""

    def __init__(self, time, marker_names, positions, metadata=None):
        self.time = np.asarray(time, dtype=np.float64)
        self.marker_names = list(marker_names)
        self.positions = np.asarray(positions, dtype=np.float64)
        self.metadata = dict(metadata or {})

    def marker(self, name):
        return self.positions[:, self.marker_names.index(name)]


def read_trc(path_or_buf) -> TrcTable:
    """Parse a .trc file or an open text buffer: line 2 holds the header
    keys and line 3 their values (a writer may pad either with tabs),
    line 4 the marker names after ``Frame#`` and ``Time``, line 5 the
    X/Y/Z components, then one frame per line. Positions are scaled from
    the ``Units`` (``mm``, ``cm`` or ``m``) to metres; a blank cell is
    NaN, and a short row is padded with NaN."""
    if isinstance(path_or_buf, (str, bytes)):
        with open(path_or_buf) as fh:
            lines = fh.read().splitlines()
    else:
        lines = path_or_buf.read().splitlines()
    if len(lines) < 6:
        raise ValueError(f"{path_or_buf}: truncated TRC file")
    keys = [c.strip() for c in lines[1].split("\t") if c.strip()]
    vals = [c.strip() for c in lines[2].split("\t") if c.strip()]
    meta = dict(zip(keys, vals))
    scale = {"mm": 1e-3, "cm": 1e-2, "m": 1.0}.get(
        meta.get("Units", "m").lower(), 1.0)
    names = [c.strip() for c in lines[3].split("\t")[2:] if c.strip()]
    rows = [[float(c) if c.strip() else np.nan for c in ln.split("\t")[1:]]
            for ln in lines[5:] if ln.strip()]
    M = len(names)
    pos = np.full((len(rows), M, 3), np.nan)
    for k, r in enumerate(rows):
        dat = r[1:1 + 3 * M]
        pos[k] = np.asarray(dat + [np.nan] * (3 * M - len(dat))).reshape(M, 3)
    return TrcTable([r[0] for r in rows], names, pos * scale, meta)
