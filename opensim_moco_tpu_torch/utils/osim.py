"""OpenSim XML readers.

Counterpart of the ExternalLoads part of ``opensim_moco_tpu.utils.osim``
(``_find_text`` ``:50``, ``parse_external_loads`` ``:655``), in pure
Python, numpy and scipy: an ExternalLoads XML names its data file and,
per ExternalForce, the body it acts on and the column prefixes of its
force, point and torque; each becomes a quintic spline of time evaluated
on tensors. The ``.osim`` model parser (the rest of the JAX module) waits
for ROADMAP.md queue 1 item 9.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET

import numpy as np

from .splines import QuinticSpline
from .tables import read_sto


def _find_text(el, tag, default=None):
    """The stripped text of ``el``'s child ``tag``, or ``default``."""
    c = el.find(tag)
    return c.text.strip() if c is not None and c.text else default


def parse_external_loads(xml_path, base_dir=None, lowpass_hz=None):
    """Read an OpenSim ExternalLoads XML and its data file (JAX
    ``utils/osim.py:655``) for ``Model.add_external_force``.

    Returns a list of dicts {name, body_name, force_fn, point_fn,
    torque_fn}: each function maps times ``t`` (...) to (..., 3) through a
    quintic interpolating spline of the columns ``<identifier>x/y/z``
    (the reference's ExternalForce samples its data through a degree-5
    GCVSpline); ``torque_fn`` is None without a torque identifier. The
    data file is read relative to ``base_dir`` (default: the XML's
    folder), low-passed first at ``lowpass_hz`` if given."""
    root = ET.parse(xml_path).getroot()
    el = root.find("ExternalLoads")
    datafile = _find_text(el, "datafile")
    base = base_dir or os.path.dirname(os.path.abspath(xml_path))
    table = read_sto(os.path.join(base, datafile))
    if lowpass_hz:
        from .processors import filter_lowpass
        table = filter_lowpass(table, lowpass_hz)
    times = np.asarray(table.time)

    def interp3(prefix):
        names = [prefix + s for s in ("x", "y", "z")]
        if any(n not in table.column_names for n in names):
            return None
        spline = QuinticSpline(times, np.stack(
            [np.asarray(table.column(n)) for n in names], axis=1))

        def fn(t, s=spline):
            return s(t)

        return fn

    out = []
    for f in el.find("objects").findall("ExternalForce"):
        tid = _find_text(f, "torque_identifier")
        out.append({
            "name": f.get("name"),
            "body_name": _find_text(f, "applied_to_body"),
            "force_fn": interp3(_find_text(f, "force_identifier")),
            "point_fn": interp3(_find_text(f, "point_identifier")),
            "torque_fn": interp3(tid) if tid else None,
        })
    return out
