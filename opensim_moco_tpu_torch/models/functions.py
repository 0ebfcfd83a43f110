"""Differentiable scalar functions used by model components.

Counterpart of ``opensim_moco_tpu.models.functions``.
``MultivariatePolynomialFunction`` keeps the reference's coefficient
ordering (ascending powers starting from the last dependent component),
so coefficient vectors fitted for OpenSim models drop in unchanged.
Derivatives of any order come from ``torch.func`` transforms of the one
evaluation below.
"""

from __future__ import annotations

import numpy as np
import torch


def _exponent_table(dimension: int, order: int) -> np.ndarray:
    """(n_terms, dimension) exponents in the reference's coefficient order
    (the nested loops of MultivariatePolynomialFunction.h:62-90)."""
    if not (1 <= dimension <= 6):
        raise ValueError(f"dimension must be in [1, 6], got {dimension}")
    rows = []

    def rec(prefix, remaining):
        if len(prefix) == dimension:
            rows.append(tuple(prefix))
            return
        for k in range(remaining + 1):
            rec(prefix + [k], remaining - k)

    rec([], order)
    return np.asarray(rows, dtype=np.int32)


class MultivariatePolynomialFunction:
    """Polynomial in up to 6 variables with reference-compatible
    coefficient ordering. Callable on a (..., dimension) tensor; returns
    (...)."""

    def __init__(self, coefficients, dimension: int, order: int):
        self.dimension = int(dimension)
        self.order = int(order)
        self._E = _exponent_table(self.dimension, self.order)
        coefficients = np.asarray(coefficients, dtype=np.float64)
        if coefficients.shape != (len(self._E),):
            raise ValueError(
                f"expected {len(self._E)} coefficients for dimension="
                f"{dimension}, order={order}; got {coefficients.shape}")
        self.coefficients = coefficients

    @property
    def n_terms(self) -> int:
        return len(self._E)

    def __call__(self, x):
        # the exponents and coefficients are static: each term is a product
        # of integer powers, built without a host-to-device copy
        total = torch.zeros_like(x[..., 0])
        for c, e in zip(self.coefficients, self._E):
            term = torch.ones_like(x[..., 0])
            for d, k in enumerate(e):
                if k > 0:
                    term = term * x[..., d] ** int(k)
            total = total + float(c) * term
        return total
