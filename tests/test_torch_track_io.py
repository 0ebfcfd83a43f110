"""The port's table processors (``opensim_moco_tpu_torch/utils/
processors.py``) and .trc reader (``utils/tables.py`` ``read_trc``)
against the JAX package's, float64 on the CPU, on tables drawn with numpy
from a fixed seed and .trc text written here.

Held: the processors' outputs within 1e-12 of the largest magnitude
(time, columns and metadata equal); ``read_trc``'s time, marker names,
metadata and NaN mask equal and its positions equal, for mm and m units,
a header row padded with tabs, blank cells and a short row."""

import io

import numpy as np
import pytest

from opensim_moco_tpu.utils import processors as jproc
from opensim_moco_tpu.utils import tables as jtab
from opensim_moco_tpu_torch.utils import processors as tproc
from opensim_moco_tpu_torch.utils import tables as ttab


def _table(mod, in_degrees="yes"):
    rng = np.random.default_rng(11)
    t = np.linspace(0.0, 1.2, 121)
    data = np.stack([np.sin(2 * np.pi * (k + 1) * t) * 30.0 for k in
                     range(3)], 1) + rng.standard_normal((121, 3))
    return mod.StoTable(t, ["/jointset/a/q/value", "/jointset/b/q/value",
                            "/forceset/m"], data,
                        {"inDegrees": in_degrees, "name": "kinematics"})


def _same(got, ref, tol=1e-12):
    np.testing.assert_array_equal(got.time, ref.time)
    assert got.column_names == ref.column_names
    assert got.metadata == ref.metadata
    scale = max(np.abs(ref.data).max(), 1e-300)
    assert np.abs(got.data - ref.data).max() <= tol * scale


@pytest.mark.parametrize("op", ["lowpass", "lowpass_coarse", "deg2rad",
                                "deg2rad_noop", "resample", "chain"])
def test_processors_parity(op):
    deg = "no" if op == "deg2rad_noop" else "yes"
    tj, tt = _table(jtab, deg), _table(ttab, deg)
    new_time = np.sort(np.random.default_rng(3).uniform(-0.1, 1.3, 57))
    calls = {
        "lowpass": lambda m, t: m.filter_lowpass(t, 6.0),
        # a cutoff above half the sampling rate: wn held at 0.999
        "lowpass_coarse": lambda m, t: m.filter_lowpass(t, 80.0),
        "deg2rad": lambda m, t: m.convert_degrees_to_radians(t),
        "deg2rad_noop": lambda m, t: m.convert_degrees_to_radians(t),
        "resample": lambda m, t: m.resample_table(t, new_time),
        "chain": lambda m, t: (m.TableProcessor(t)
                               | m.TabOpConvertDegreesToRadians()
                               | m.TabOpLowPassFilter(6.0)).process(),
    }
    _same(calls[op](tproc, tt), calls[op](jproc, tj))


def test_table_processor_from_path(tmp_path):
    path = str(tmp_path / "k.sto")
    ttab.write_sto(path, _table(ttab))
    ref = (jproc.TableProcessor(path) | jproc.TabOpLowPassFilter(6.0)
           ).process()
    got = (tproc.TableProcessor(path) | tproc.TabOpLowPassFilter(6.0)
           ).process()
    _same(got, ref)


def _trc_text(units, pad):
    """Three markers at 6 frames: blank cells in frames 2 and 4, frame 5
    cut short after the second marker's x."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(-900.0, 900.0, (6, 9))
    tail = "\t" * pad
    lines = ["PathFileType\t4\t(X/Y/Z)\tsample.trc",
             "DataRate\tCameraRate\tNumFrames\tNumMarkers\tUnits\t"
             "OrigDataRate" + tail,
             f"100\t100\t6\t3\t{units}\t100" + tail,
             "Frame#\tTime\tA\t\t\tB.R\t\t\tC" + tail,
             "\t\tX1\tY1\tZ1\tX2\tY2\tZ2\tX3\tY3\tZ3"]
    for k in range(6):
        cells = [f"{v:.17g}" for v in pos[k]]
        if k == 2:
            cells[3:6] = ["", "", ""]
        if k == 4:
            cells[0] = ""
        if k == 5:
            cells = cells[:4]
        lines.append("\t".join([str(k + 1), f"{0.01 * k:.17g}"] + cells))
    return "\n".join(lines) + "\n"


@pytest.mark.parametrize("units,pad", [("mm", 3), ("m", 0), ("cm", 1)])
def test_read_trc_parity(tmp_path, units, pad):
    path = str(tmp_path / "m.trc")
    text = _trc_text(units, pad)
    with open(path, "w") as fh:
        fh.write(text)
    ref = jtab.read_trc(path)
    for got in (ttab.read_trc(path), ttab.read_trc(io.StringIO(text))):
        np.testing.assert_array_equal(got.time, ref.time)
        assert got.marker_names == ref.marker_names == ["A", "B.R", "C"]
        assert got.metadata == ref.metadata
        assert got.metadata["Units"] == units
        np.testing.assert_array_equal(np.isnan(got.positions),
                                      np.isnan(ref.positions))
        np.testing.assert_array_equal(got.positions, ref.positions)
        np.testing.assert_array_equal(got.marker("B.R"), ref.marker("B.R"))
    nan = np.isnan(ref.positions)
    assert nan[2, 1].all() and nan[4, 0, 0] and nan[5, 1, 1:].all() \
        and nan[5, 2].all() and nan.sum() == 3 + 1 + 2 + 3


def test_read_trc_truncated(tmp_path):
    path = str(tmp_path / "short.trc")
    with open(path, "w") as fh:
        fh.write("PathFileType\t4\nDataRate\n")
    with pytest.raises(ValueError, match="truncated"):
        ttab.read_trc(path)
