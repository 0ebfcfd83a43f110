"""NLP problem statement in IPOPT standard form.

    minimize    f(z)
    subject to  c(z) = 0
                l <= z <= u

Counterpart of ``opensim_moco_tpu.solver.nlp.NLP``. ``objective`` and
``constraints`` take tensors with any leading dimensions,
``(..., n) -> (...)`` and ``(..., n) -> (..., m)``, and must be
composable with ``torch.func`` transforms (no in-place writes, no host
reads of tensor values). ``structure`` is always None for now: the
time-grouped KKT structure is not ported yet (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np


@dataclasses.dataclass(frozen=True)
class NLP:
    n: int
    m: int
    objective: Callable  # (..., n) -> (...)
    constraints: Callable  # (..., n) -> (..., m)
    lb: np.ndarray  # (n,), -inf where absent
    ub: np.ndarray  # (n,), +inf where absent
    structure: None = None
