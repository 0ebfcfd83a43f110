"""K1 (the batched block-tridiagonal KKT factor and solve) and its plain
PyTorch version, without the JAX package, so that these tests also run on
a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(``--noconftest``: ``tests/conftest.py`` sets up JAX.) On the CPU the
``cuda`` tests skip; the others check the plain version against a dense
solve of the assembled KKT matrix at ragged shapes and on a singular
block, and that K1's wrapper takes the plain path for a CPU tensor. On the
card, K1 agrees with the plain version to relative 1e-10 of the largest
magnitude on well-conditioned random blocks (float64; the two sum in
different orders) at shapes that cross every 32-row triangle, 32-column
panel and 64-wide product tile edge and the bound between the kernel's
two memory modes (``ops.btb.EDGE_SHAPES``, which ``chip_smoke.py`` phase
8d also sweeps), each with 1, 2 and 9 right-hand sides, and at the widest
block it takes; a singular lane stays non-finite in both modes; and a
solve whose right-hand sides do not fit the kernel's shared memory raises
before launch.
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


@pytest.mark.parametrize("N,nb,k", [(1, 5, 1), (2, 31, 0), (3, 33, 4),
                                    (2, 65, 1), (16, 5, 4), (4, 32, 1)])
def test_plain_btb_matches_dense_solve(N, nb, k):
    """The plain btb factor and solve (the card test's reference) against
    torch.linalg.solve of the assembled KKT matrix, to relative 1e-10."""
    D, L, Bm, C = _random_blocks(2, N, nb, k, seed=nb + 7 * N + k)
    rng = np.random.default_rng(N * nb)
    rhs_T = torch.as_tensor(rng.standard_normal((2, N, nb, 3)))
    rhs_C = torch.as_tensor(rng.standard_normal((2, k, 3)))
    x, w = ts.btb_solve(ts.btb_factor(D, L, Bm, C), rhs_T, rhs_C)
    ref = torch.linalg.solve(ts.dense_kkt(D, L, Bm, C),
                             torch.cat([rhs_T.reshape(2, -1, 3), rhs_C], 1))
    assert _rel(torch.cat([x.reshape(2, -1, 3), w], 1), ref) <= 1e-10


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
@pytest.mark.parametrize("r", [1, 2, 9])
@pytest.mark.parametrize("N,nb,k", k1.EDGE_SHAPES)
def test_k1_matches_plain_on_card(cuda_device, N, nb, k, r):
    """K1 against its plain version on the card (skipped without one), for
    one right-hand side in the main path's form (rhs_T (B, N, nb)) and for
    2 and 9 (one past the 8 that the solve's narrow kernel takes)."""
    Bt = 2
    blocks = [t.to(cuda_device) for t in
              _random_blocks(Bt, N, nb, k, seed=nb + 7 * N + k)]
    rng = np.random.default_rng(nb)
    cols = () if r == 1 else (r,)
    rhs_T = torch.as_tensor(rng.standard_normal((Bt, N, nb) + cols),
                            device=cuda_device)
    rhs_C = torch.as_tensor(rng.standard_normal((Bt, k) + cols),
                            device=cuda_device)
    x_k, w_k = k1.btb_solve(k1.btb_factor(*blocks), rhs_T, rhs_C)
    x_p, w_p = ts.btb_solve(ts.btb_factor(*blocks), rhs_T, rhs_C)
    assert x_k.shape == rhs_T.shape and w_k.shape == rhs_C.shape
    for lane in range(Bt):
        assert _rel(torch.cat([x_k[lane].flatten(), w_k[lane].flatten()]),
                    torch.cat([x_p[lane].flatten(), w_p[lane].flatten()])
                    ) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [34, 200])
def test_k1_singular_lane_on_card(cuda_device, nb):
    """A singular Schur block gives non-finite output in its own lane only,
    in the shared-memory (nb=34) and the device-memory (nb=200) mode."""
    assert k1.use_shared_memory(nb, 1) == (nb == 34)
    D, L, Bm, C = [t.to(cuda_device) for t in
                   _random_blocks(2, 4, nb, 1, seed=nb)]
    D[1, 2] = 0.0  # lane 1: D_2 = 0, and L_1 = 0 keeps S_2 = 0
    L[1, 1] = 0.0
    x, w = k1.btb_solve(k1.btb_factor(D, L, Bm, C),
                        torch.ones_like(D[..., 0]), torch.ones_like(C[..., 0]))
    torch.cuda.synchronize()
    assert torch.isfinite(x[0]).all() and torch.isfinite(w[0]).all()
    assert not torch.isfinite(x[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("k", [0, 23])
def test_k1_widest_block_on_card(cuda_device, k):
    """At the widest block the factor takes (``MAX_NB``, device-memory
    mode) K1 agrees with its plain version; a block one row wider raises
    before launch."""
    nb = k1.MAX_NB
    assert not k1.use_shared_memory(nb, k)
    blocks = [t.to(cuda_device) for t in _random_blocks(1, 2, nb, k, seed=k)]
    rng = np.random.default_rng(k)
    rhs_T = torch.as_tensor(rng.standard_normal((1, 2, nb, 2)),
                            device=cuda_device)
    rhs_C = torch.as_tensor(rng.standard_normal((1, k, 2)),
                            device=cuda_device)
    x_k, w_k = k1.btb_solve(k1.btb_factor(*blocks), rhs_T, rhs_C)
    x_p, w_p = ts.btb_solve(ts.btb_factor(*blocks), rhs_T, rhs_C)
    assert _rel(torch.cat([x_k.flatten(), w_k.flatten()]),
                torch.cat([x_p.flatten(), w_p.flatten()])) <= 1e-10
    wider = [t.to(cuda_device) for t in _random_blocks(1, 2, nb + 1, k)]
    with pytest.raises(ValueError, match="wider than the kernel takes"):
        k1.btb_factor(*wider)


@pytest.mark.cuda
def test_k1_solve_raises_above_shared_memory(cuda_device):
    """At the widest block, a solve with more right-hand sides than the
    solve kernel's shared memory holds raises before launch, naming the
    limit."""
    nb, k = k1.MAX_NB, 23
    z = torch.zeros
    f64 = dict(dtype=torch.float64, device=cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    fac = ts.BTBFac(z(1, 1, nb, nb, **f64), z(1, 1, nb, **i32),
                    z(1, 0, nb, nb, **f64), z(1, 1, nb, k, **f64),
                    z(1, 1, nb, k, **f64), z(1, k, k, **f64),
                    z(1, k, **i32))
    r = 64
    before = k1.LAUNCHES["btb_solve"]
    with pytest.raises(ValueError, match=f"limit of {k1.SMEM_LIMIT}"):
        k1.btb_solve(fac, z(1, 1, nb, r, **f64), z(1, k, r, **f64))
    assert k1.LAUNCHES["btb_solve"] == before
