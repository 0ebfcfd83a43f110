"""IPM parity with the JAX package under ``kkt="structured"`` (cases and
tolerances in ``test_torch_ipm_common.py``), plus the routing of each
``kkt`` mode through the btb factor."""

import pytest

from opensim_moco_tpu_torch.ops import btb as k1
from opensim_moco_tpu_torch.solver import ipm as tipm
from test_torch_ipm_common import (BENCH, check_batch_solve_parity,
                                   check_iterate_parity, make_kernels,
                                   make_problem)


@pytest.fixture(scope="module")
def problem():
    return make_problem()


@pytest.fixture(scope="module")
def kernels(problem):
    return make_kernels(problem, "structured")


def test_structured_iterate_parity_with_jax(problem, kernels):
    check_iterate_parity(problem, kernels)


def test_structured_batch_solve_parity_with_jax(problem, kernels):
    check_batch_solve_parity(problem, kernels)


@pytest.mark.parametrize("kkt,min_dim,init_calls,step_calls", [
    ("dense", 1200, 0, 0),
    ("auto", 1200, 1, 0),  # n+m < 1200: btb for the least-squares start
    ("auto", 0, 1, 1),  # at or above the threshold: btb everywhere
    ("structured", 1200, 1, 1),
])
def test_kkt_mode_routing(problem, monkeypatch, kkt, min_dim, init_calls,
                          step_calls):
    """Which KKT factor each mode takes: btb factor calls in ``init_fn``
    and in the first ``body_fn`` (at least one per regularization
    trial)."""
    _, trt, Z0, z0 = problem
    calls = []
    real = k1.btb_factor

    def counted(*blocks):
        calls.append(blocks[0].shape)
        return real(*blocks)

    monkeypatch.setattr(k1, "btb_factor", counted)
    init_t, body_t, _, _ = tipm.make_kernel(
        trt.make_nlp("cpu"), tipm.IPMOptions(**BENCH, kkt=kkt,
                                             kkt_structured_min_dim=min_dim),
        scale_z0=z0, device="cpu")
    carry = init_t(Z0)
    assert len(calls) == init_calls
    body_t(carry)
    assert (len(calls) > init_calls) == bool(step_calls)
    for shape in calls:
        assert shape[0] == len(Z0) and shape[1] == 10  # B lanes, N blocks
