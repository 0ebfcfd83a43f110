"""Batched solves of one transcription from many starting points.

Counterpart of ``opensim_moco_tpu.parallel.batch``. The port's solver is
batched natively (a leading lane dimension), so no ``vmap`` is needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..solver.ipm import IPMOptions, make_solver
from ..transcribe.transcription import Transcription


def make_batched_solver(transcription: Transcription,
                        ipm_options: IPMOptions, device="cuda",
                        dtype=torch.float64, scale_z0=None):
    """``solve(Z0) -> IPMResult`` for Z0 of shape (B, n) on ``device``.

    ``scale_z0`` enables gradient-based NLP scaling at that point; the JAX
    package's ``make_batched_solver`` passes none, while its bench and
    ``Study.solve`` scale at the initial guess."""
    nlp = transcription.make_nlp(device, dtype)
    return make_solver(nlp, ipm_options, scale_z0, device=device,
                       dtype=dtype)


def batch_guesses(transcription: Transcription, batch: int, scale=0.0,
                  seed=0):
    """(B, n) numpy stack of bounds-midpoint guesses, optionally jittered
    for multistart; the same RNG calls as the JAX package, so the same
    seed gives the same starts."""
    g = np.asarray(transcription.initial_guess())
    Z0 = np.tile(g, (batch, 1))
    if scale:
        rng = np.random.default_rng(seed)
        lb, ub = [np.asarray(a) for a in transcription.bounds()]
        width = np.where(np.isfinite(ub - lb), ub - lb, 1.0)
        jitter = rng.uniform(-scale, scale, Z0.shape) * width
        free = ~((lb == ub) & np.isfinite(lb))
        Z0 = Z0 + jitter * free
        Z0 = np.clip(Z0, lb, ub)
    return Z0
