"""K1 (the batched block-tridiagonal KKT factor and solve) and its plain
PyTorch version, without the JAX package, so that these tests also run on
a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX.) On the CPU the
``cuda`` test skips; the others check the plain version on a singular
block and that K1's wrapper takes the plain path for a CPU tensor. On the
card, K1 agrees with the plain version to relative 1e-10 of the largest
magnitude on well-conditioned random blocks (float64; the two sum in
different orders), in both of the kernel's memory modes.
"""

import numpy as np
import pytest
import torch

from opensim_moco_tpu_torch.ops import _build
from opensim_moco_tpu_torch.ops import btb as k1
from opensim_moco_tpu_torch.solver import structured as ts


def _rel(a, b):
    a, b = a.detach().cpu(), b.detach().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def _random_blocks(Bt=2, N=4, nb=5, k=2, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((Bt, N, nb, nb))
    D = D + np.swapaxes(D, -1, -2) + 4 * nb * np.eye(nb)
    L = rng.standard_normal((Bt, N - 1, nb, nb))
    Bm = rng.standard_normal((Bt, N, nb, k))
    C = rng.standard_normal((Bt, k, k)) + 4 * N * nb * np.eye(k)
    return [torch.as_tensor(a) for a in (D, L, Bm, C)]


def test_singular_block_gives_nonfinite_output():
    """The regularization loop reads a non-finite step as "raise delta":
    a singular Schur block must neither raise nor be fixed up."""
    D, L, Bm, C = _random_blocks()
    D[1, 2] = 0.0  # lane 1: D_2 = 0, and L_1 = 0 keeps S_2 = 0
    L[1, 1] = 0.0
    fac = ts.btb_factor(D, L, Bm, C)
    x, w = ts.btb_solve(fac, torch.ones(2, 4, 5, dtype=torch.float64),
                        torch.ones(2, 2, dtype=torch.float64))
    assert torch.isfinite(x[0]).all() and torch.isfinite(w[0]).all()
    assert not torch.isfinite(x[1]).all()


def test_k1_wrapper_on_cpu_takes_plain_path(monkeypatch):
    """On a CPU tensor K1's wrapper is the plain version: the same
    result, no launch counted, nothing built."""
    def no_build(*args):
        raise AssertionError("the CPU path must not build a kernel")

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(k1, "load", no_build)
    before = dict(k1.LAUNCHES)
    blocks = _random_blocks(Bt=3, N=5, nb=6, k=1, seed=1)
    fac_k, fac_p = k1.btb_factor(*blocks), ts.btb_factor(*blocks)
    for a, b in zip(fac_k, fac_p):
        assert torch.equal(a, b)
    rhs = (torch.ones(3, 5, 6, 2, dtype=torch.float64),
           torch.ones(3, 1, 2, dtype=torch.float64))
    for a, b in zip(k1.btb_solve(fac_k, *rhs), ts.btb_solve(fac_p, *rhs)):
        assert torch.equal(a, b)
    assert k1.LAUNCHES == before


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1 has no CPU interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k1_matches_plain_on_card(cuda_device):
    """K1 against its plain version on the card (skipped without one)."""
    for seed, (Bt, N, nb, k) in enumerate([(3, 5, 6, 1), (2, 4, 40, 0),
                                           (2, 3, 130, 3)]):
        blocks = [t.to(cuda_device) for t in
                  _random_blocks(Bt, N, nb, k, seed)]
        rhs_T = torch.ones(Bt, N, nb, 2, dtype=torch.float64,
                           device=cuda_device)
        rhs_C = torch.ones(Bt, k, 2, dtype=torch.float64, device=cuda_device)
        x_k, w_k = k1.btb_solve(k1.btb_factor(*blocks), rhs_T, rhs_C)
        x_p, w_p = ts.btb_solve(ts.btb_factor(*blocks), rhs_T, rhs_C)
        assert _rel(torch.cat([x_k.flatten(), w_k.flatten()]),
                    torch.cat([x_p.flatten(), w_p.flatten()])) <= 1e-10
