"""The port's .sto reader and writer (``opensim_moco_tpu_torch/utils/
tables.py``): a write/read round trip, and the port's ``read_sto`` of a
file written by the JAX package's ``write_sto`` equal to the JAX package's
``read_sto`` of it (time, columns, data, metadata, ``in_degrees``). Data
drawn with numpy from a fixed seed."""

import io

import numpy as np

from opensim_moco_tpu.utils import tables as jtab
from opensim_moco_tpu_torch.utils import tables as ttab


def _table(mod, meta):
    rng = np.random.default_rng(7)
    time = np.linspace(0.0, 1.3, 11)
    data = rng.standard_normal((11, 3)) * 10.0 ** rng.integers(-8, 8, 3)
    return mod.StoTable(time, ["/jointset/j/q/value", "/forceset/m",
                               "lambda_cid0_p0"], data, meta)


def test_round_trip(tmp_path):
    tab = _table(ttab, {"name": "trial", "inDegrees": "yes",
                        "DataType": "double"})
    path = str(tmp_path / "t.sto")
    ttab.write_sto(path, tab)
    back = ttab.read_sto(path)
    np.testing.assert_array_equal(back.time, tab.time)
    np.testing.assert_array_equal(back.data, tab.data)
    assert back.column_names == tab.column_names
    assert back.metadata["name"] == "trial"
    assert back.metadata["version"] == "3"
    assert back.metadata["nRows"] == "11"
    assert back.in_degrees()
    np.testing.assert_array_equal(back.column("/forceset/m"), tab.data[:, 1])
    with open(path) as fh:
        buf = ttab.read_sto(io.StringIO(fh.read()))
    np.testing.assert_array_equal(buf.data, tab.data)


def test_reads_jax_written_file_like_jax(tmp_path):
    path = str(tmp_path / "j.sto")
    jtab.write_sto(path, _table(jtab, {"inDegrees": "no", "version": "1"}),
                   name="coordinates")
    ref, got = jtab.read_sto(path), ttab.read_sto(path)
    np.testing.assert_array_equal(got.time, ref.time)
    np.testing.assert_array_equal(got.data, ref.data)
    assert got.column_names == ref.column_names
    assert got.metadata == ref.metadata
    assert got.in_degrees() == ref.in_degrees() is False
