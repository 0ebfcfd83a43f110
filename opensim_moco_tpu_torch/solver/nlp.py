"""NLP problem statement in IPOPT standard form.

    minimize    f(z)
    subject to  c(z) = 0
                l <= z <= u

Counterpart of ``opensim_moco_tpu.solver.nlp``. ``objective`` and
``constraints`` take tensors with any leading dimensions,
``(..., n) -> (...)`` and ``(..., n) -> (..., m)``, and must be
composable with ``torch.func`` transforms (no in-place writes, no host
reads of tensor values). ``structure`` optionally carries the
time-grouped KKT block structure that the structured derivatives and the
block-tridiagonal KKT factor use.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class KKTStructure:
    """Time-grouped block structure of a transcription NLP.

    Direct collocation couples variables and constraints only between
    adjacent mesh intervals, plus a thin border (times, parameters,
    endpoint constraints) that couples everything. With variables and
    constraints grouped per interval the KKT matrix is bordered
    block-tridiagonal and factors in O(N nb^3) instead of O((N nb)^3).

    ``var_blocks``/``con_blocks``: per-interval lists of variable /
    constraint indices (original index space). ``border_vars``/
    ``border_cons``: indices coupling to every block.
    """

    var_blocks: list  # N lists of int variable indices
    con_blocks: list  # N lists of int constraint-row indices
    border_vars: np.ndarray  # (kv,) int
    border_cons: np.ndarray  # (kc,) int


@dataclasses.dataclass(frozen=True)
class NLP:
    n: int
    m: int
    objective: Callable  # (..., n) -> (...)
    constraints: Callable  # (..., n) -> (..., m)
    lb: np.ndarray  # (n,), -inf where absent
    ub: np.ndarray  # (n,), +inf where absent
    structure: KKTStructure | None = None
