"""The port's chunked solver and ``Study.solve``'s checkpoints, warm start
and interrupt file, float64 on the CPU (port only; the JAX package's
checkpoint file is compared in ``test_torch_chunked_jax.py``).

Held: ``make_chunked_solver`` in chunks of 3 iterations gives every field
of ``make_solver``'s result bit for bit on a batch of 4 jittered starts
of Kirk's problem (mesh 20), each chunk stopping its lanes at its limit;
the JAX test's assertions (``tests/test_checkpointing.py``) on
``kirk_min_effort_study(20)``: a solve with ``checkpoint_interval=5``
converges and writes its file, a warm start from that file converges in
at most 2 more iterations to the same objective (1e-6), and a solve whose
interrupt file is gone stops by iteration 6; the checkpointed solve
equals the unchunked one, and its file reads back to the returned
solution.
"""

import os

import numpy as np
import pytest
import torch

from opensim_moco_tpu_torch.examples import kirk_min_effort_study
from opensim_moco_tpu_torch.parallel import batch_guesses
from opensim_moco_tpu_torch.solver.ipm import (IPMOptions,
                                               make_chunked_solver,
                                               make_solver)
from opensim_moco_tpu_torch.utils.tables import sto_to_trajectory


def test_chunks_take_the_same_steps_as_one_solve():
    tr = kirk_min_effort_study(20).transcription()
    opts = IPMOptions(tol=1e-7, max_iter=40, kkt="structured")
    z0 = tr.initial_guess()
    Z0 = batch_guesses(tr, 4, scale=0.05, seed=0)
    ref = make_solver(tr.make_nlp("cpu"), opts, z0, device="cpu")(Z0)
    init_fn, run_chunk, finalize_fn = make_chunked_solver(
        tr.make_nlp("cpu"), opts, z0, device="cpu")
    carry = init_fn(Z0)
    limit = 0
    while True:
        limit += 3
        carry = run_chunk(carry, limit)
        assert int(carry.it.max()) <= limit
        if not bool(((~carry.converged) &
                     (carry.it < opts.max_iter)).any()):
            break
    got = finalize_fn(carry)
    assert limit > 6 and bool(ref.converged.all())
    for name, a in ref._asdict().items():
        assert torch.equal(getattr(got, name), a), name


def test_checkpoint_warm_start_and_interrupt(tmp_path):
    study = kirk_min_effort_study(num_mesh_intervals=20)
    study.set_ipm_options(tol=1e-7, max_iter=200)
    ckpt = str(tmp_path / "iterate.sto")
    sol = study.solve("cpu", checkpoint_interval=5, checkpoint_path=ckpt)
    assert sol.success
    assert os.path.exists(ckpt)
    one = study.solve("cpu")
    np.testing.assert_array_equal(sol.raw_iterate, one.raw_iterate)
    assert sol.num_iterations == one.num_iterations > 5
    back = sto_to_trajectory(ckpt)
    for name in ("time", "states", "controls"):
        np.testing.assert_array_equal(getattr(back, name),
                                      getattr(sol, name))
    guess = study.create_guess_from_file(ckpt)
    sol2 = study.solve("cpu", guess=guess)
    assert sol2.success
    assert sol2.num_iterations <= sol.num_iterations + 2
    assert abs(sol2.objective - sol.objective) < 1e-6

    study.set_ipm_options(tol=1e-12, max_iter=10000)  # would run long
    stopfile = tmp_path / "keep_running.txt"
    stopfile.write_text("delete this to stop the optimization")
    stopfile.unlink()  # deleted before the solve: stop after one chunk
    sol3 = study.solve("cpu", checkpoint_interval=3,
                       interrupt_file=str(stopfile))
    assert sol3.num_iterations <= 6


def test_solve_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    study = kirk_min_effort_study(num_mesh_intervals=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        study.solve(checkpoint_interval=2,
                    checkpoint_path=str(tmp_path / "x.sto"))
    with pytest.raises(RuntimeError, match="CUDA"):
        study.create_guess("bounds")
    with pytest.raises(RuntimeError, match="CUDA"):
        study.objective_breakdown(study.solve("cpu"))
