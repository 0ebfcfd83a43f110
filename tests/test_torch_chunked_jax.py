"""The port's checkpoint file against the JAX package's, float64 on the
CPU: ``kirk_min_effort_study(20)`` with ``max_iter`` 5, each package
writing the iterate of its first chunk of 5 iterations. The port's file
comes from ``Study.solve(checkpoint_interval=5, checkpoint_path=...)``;
the JAX package's from the steps of its ``Study.solve`` in that mode
(``make_chunked_solver``, the chunk, ``Study._expand`` and
``trajectory_to_sto``), with its ``init_fn`` and ``finalize_fn`` jitted:
run op by op, as its ``Study.solve`` runs them, they take about 20 s
more. A file of its own: the JAX package compiles its solver.

Held: the two files have the same header keys and columns, the same
iteration count, success flag and status, and states, controls and
objective within 1e-6 of their magnitude (the IPM parity tests' tolerance
under ``kkt="dense"``: both packages take the same steps, one rounding
apart).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu.solver.ipm import \
    make_chunked_solver as jax_make_chunked_solver
from opensim_moco_tpu.utils.tables import read_sto as jax_read_sto
from opensim_moco_tpu.utils.tables import \
    trajectory_to_sto as jax_trajectory_to_sto
from opensim_moco_tpu_torch import examples as tex
from opensim_moco_tpu_torch.utils.tables import read_sto, sto_to_trajectory
from test_torch_constrained_common import one_blas_thread


def test_first_chunk_checkpoint_matches_jax(tmp_path):
    jpath, tpath = str(tmp_path / "jax.sto"), str(tmp_path / "port.sto")
    studies = []
    for ex in (jex, tex):
        study = ex.kirk_min_effort_study(num_mesh_intervals=20)
        study.set_ipm_options(tol=1e-7, max_iter=5, kkt="dense")
        studies.append(study)
    sj, st = studies
    sol = st.solve("cpu", checkpoint_interval=5, checkpoint_path=tpath)
    assert sol.num_iterations == 5 and not sol.success
    with one_blas_thread():
        start = time.perf_counter()
        tr = sj.transcription()
        z0 = tr.initial_guess()
        init_fn, run_chunk, finalize_fn = jax_make_chunked_solver(
            tr.make_nlp(), sj.ipm_options, scale_z0=z0)
        carry = run_chunk(jax.jit(init_fn)(jnp.asarray(z0)), 5)
        snap = sj._expand(tr, tr.rep, jax.jit(finalize_fn)(carry), start)
        jax_trajectory_to_sto(snap.unseal(), jpath)
    tj, tt = jax_read_sto(jpath), read_sto(tpath)
    assert list(tt.metadata) == list(tj.metadata)
    assert tt.column_names == tj.column_names
    for key in ("success", "num_iterations", "status", "num_states"):
        assert tt.metadata[key] == tj.metadata[key], key
    np.testing.assert_array_equal(tt.time, tj.time)
    assert np.abs(tt.data - tj.data).max() <= 1e-6 * np.abs(tj.data).max()
    fj, ft = (float(t.metadata["objective"]) for t in (tj, tt))
    assert abs(ft - fj) <= 1e-6 * abs(fj)
    back = sto_to_trajectory(tpath)
    assert back.states.shape == (41, 2) and back.controls.shape == (41, 1)
