"""IPM parity with the JAX package under ``kkt="auto"``, the JAX bench's
own mode (cases and tolerances in ``test_torch_ipm_common.py``)."""

import pytest

from test_torch_ipm_common import (check_batch_solve_parity,
                                   check_iterate_parity, make_kernels,
                                   make_problem)


@pytest.fixture(scope="module")
def problem():
    return make_problem()


@pytest.fixture(scope="module")
def kernels(problem):
    return make_kernels(problem, "auto")


def test_auto_iterate_parity_with_jax(problem, kernels):
    check_iterate_parity(problem, kernels)


def test_auto_batch_solve_parity_with_jax(problem, kernels):
    check_batch_solve_parity(problem, kernels)
