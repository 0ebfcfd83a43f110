"""K1: the batched bordered block-tridiagonal KKT factor and solve.

Wrappers of the hand-written CUDA kernels in ``csrc/btb.cu`` (see the note
there: what they replace, what bounds them, what their design does about
it). Same signatures and results as the plain PyTorch versions
``solver.structured.btb_factor`` and ``btb_solve``:

* a CPU tensor takes the plain version (that is how the CPU tests run);
* a CUDA tensor takes the kernel, or raises: float64 only, contiguous,
  consistent shapes, launched on the current stream, a non-zero launch
  status raises. Nothing falls back to the plain version on the card.

``LAUNCHES`` counts kernel launches per kernel (plain calls are not
counted), so a run can show that its main path went through them.
"""

from __future__ import annotations

import ctypes

import torch

from ..solver.structured import BTBFac
from ..solver.structured import btb_factor as btb_factor_plain
from ..solver.structured import btb_solve as btb_solve_plain
from ._build import load

LAUNCHES = {"btb_factor": 0, "btb_solve": 0}
# bytes of dynamic shared memory a kernel may ask for: the 227 KB a block
# may have on sm_90, less 1 KB for the factor's static shared memory
SMEM_LIMIT = 232448 - 1024
# the widest block the factor takes at k <= 23. Its device-memory mode
# stages a panel buffer in shared memory of the largest of nb x 33 doubles
# (the LU's panels), 32 x (nb + k) (a block of the triangle solves'
# right-hand sides) and nb x k (the back sweep's block): nb x 33 sets the
# limit up to k = 23 (738), 32 x (nb + k) from k = 24 to 33 (737 down to
# 729), nb x k from k = 34 (717; 642 at k = 38)
MAX_NB = 738
# (N, nb, k) that cross the factor's edges: 32-row triangles and 32-column
# panels (31-33, 63-65; 64 rows is also where a panel passes from one warp
# to the whole block), 64-wide product tiles, the bound between its shared-
# and device-memory modes (nb 109-112 for k = 4..0; 115, 116 and 200 in
# device memory), N = 1 (no L block), a border of 0 and of 2 (a parameter
# and an endpoint-constraint row); nb 64/65 also crosses the solve's choice
# between its narrow and its wide kernel. Then the wide borders of
# periodicity rows: k = 16, 20 and 24 across their memory-mode bound (nb
# 107 for k = 16, 105 for k = 20 and 24), and the contact leg's own shape
# (``examples.contact_leg_study``: N = 50, nb = 120, k = 15). Then the
# borders around k = 33, where the panel's nb x k term takes over from
# 32 x (nb + k) at the widest blocks: k = 32, 33, 34 and 38 across their
# memory-mode bound (the last shared-memory nb: 103, 102, 102 and 101), at
# nb = 200 and 266 in device memory (where nb x k is the largest term at
# k = 38) and at the widest nb k = 34 and 38 take (717, 642); and the
# walker's own shape without and with its pelvis residuals
# (``examples.walker2d_track_study``: N = 50, nb = 266 and 278, k = 38,
# the half-cycle symmetry rows)
EDGE_NBS = (1, 5, 31, 32, 33, 34, 63, 64, 65, 109, 110, 111, 112, 115, 116,
            200)
WIDE_BORDERS = {32: 103, 33: 102, 34: 102, 38: 101}  # k: last smem nb
EDGE_SHAPES = ([(N, nb, k) for N in (1, 2, 16) for nb in EDGE_NBS
                for k in (0, 1, 2, 4)] +
               [(N, nb, k) for N in (1, 2) for nb in (104, 105, 106, 107, 108)
                for k in (16, 20, 24)] + [(50, 120, 15)] +
               [(N, nb, k) for k, last in WIDE_BORDERS.items()
                for N in (1, 2) for nb in (last, last + 1, 200, 266)] +
               [(1, 717, 34), (1, 642, 38), (50, 266, 38), (50, 278, 38)])

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    lib = load("btb")
    if not getattr(lib, "_typed", False):
        lib.btb_factor_f64.argtypes = [_P] * 10 + [_I] * 5 + [_P]
        lib.btb_factor_f64.restype = _I
        lib.btb_solve_f64.argtypes = [_P] * 11 + [_I] * 5 + [_P]
        lib.btb_solve_f64.restype = _I
        lib.btb_factor_smem_bytes.argtypes = [_I] * 3
        lib.btb_factor_smem_bytes.restype = ctypes.c_size_t
        lib.btb_solve_smem_bytes.argtypes = [_I] * 3
        lib.btb_solve_smem_bytes.restype = ctypes.c_size_t
        lib.btb_solve_narrow.argtypes = [_I] * 3
        lib.btb_solve_narrow.restype = _I
        lib.btb_error_string.argtypes = [_I]
        lib.btb_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def _check(name, t, shape, dtype=torch.float64):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(lib, rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.btb_error_string(rc).decode()}")


def use_shared_memory(nb, k):
    """Whether the factor keeps its working blocks (the Schur block and the
    nb x (nb + k) right-hand sides) in shared memory."""
    return _lib().btb_factor_smem_bytes(nb, k, 1) <= SMEM_LIMIT


def narrow_solve(nb, k, r):
    """Whether the solve takes its narrow kernel (r <= 8 right-hand sides,
    nb and k <= 64) or its wide one."""
    return bool(_lib().btb_solve_narrow(nb, k, r))


def btb_factor(D, L, B, C) -> BTBFac:
    """Factor [[T, B], [B^T, C]] per lane (see ``structured.btb_factor``):
    D (Bt, N, nb, nb), L (Bt, N-1, nb, nb), B (Bt, N, nb, k), C (Bt, k, k)."""
    if D.device.type == "cpu":
        return btb_factor_plain(D, L, B, C)
    Bt, N, nb, _ = D.shape
    k = B.shape[-1]
    _check("D", D, (Bt, N, nb, nb))
    _check("L", L, (Bt, N - 1, nb, nb))
    _check("B", B, (Bt, N, nb, k))
    _check("C", C, (Bt, k, k))
    if Bt == 0 or N < 1 or nb == 0:
        raise ValueError(f"btb_factor: empty problem {tuple(D.shape)}")
    smem = use_shared_memory(nb, k)
    lib = _lib()
    if not smem and lib.btb_factor_smem_bytes(nb, k, 0) > SMEM_LIMIT:
        raise ValueError(f"btb_factor: nb={nb}, k={k} is wider than the "
                         f"kernel takes (nb up to {MAX_NB} for k up to 23, "
                         "less for wider borders)")
    S_lu = torch.empty_like(D)
    S_piv = torch.empty((Bt, N, nb), dtype=torch.int32, device=D.device)
    Tinv_B = torch.empty_like(B)
    Sb_lu = torch.empty_like(C)
    Sb_piv = torch.empty((Bt, k), dtype=torch.int32, device=D.device)
    scratch = None if smem else D.new_empty((Bt, nb, nb + k))
    rc = lib.btb_factor_f64(
        D.data_ptr(), L.data_ptr(), B.data_ptr(), C.data_ptr(),
        S_lu.data_ptr(), S_piv.data_ptr(), Tinv_B.data_ptr(),
        Sb_lu.data_ptr(), Sb_piv.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        Bt, N, nb, k, int(smem),
        torch.cuda.current_stream(D.device).cuda_stream)
    _raise_on(lib, rc, "btb_factor")
    LAUNCHES["btb_factor"] += 1
    return BTBFac(S_lu, S_piv, L, B, Tinv_B, Sb_lu, Sb_piv)


def btb_solve(fac: BTBFac, rhs_T, rhs_C):
    """Solve with a factorization (see ``structured.btb_solve``):
    rhs_T (Bt, N, nb[, r]), rhs_C (Bt, k[, r])."""
    if rhs_T.device.type == "cpu":
        return btb_solve_plain(fac, rhs_T, rhs_C)
    single = rhs_T.dim() == 3
    if single:
        rhs_T, rhs_C = rhs_T[..., None], rhs_C[..., None]
    Bt, N, nb, r = rhs_T.shape
    k = fac.B.shape[-1]
    _check("S_lu", fac.S_lu, (Bt, N, nb, nb))
    _check("S_piv", fac.S_piv, (Bt, N, nb), torch.int32)
    _check("L", fac.L, (Bt, N - 1, nb, nb))
    _check("B", fac.B, (Bt, N, nb, k))
    _check("Tinv_B", fac.Tinv_B, (Bt, N, nb, k))
    _check("Sb_lu", fac.Sb_lu, (Bt, k, k))
    _check("Sb_piv", fac.Sb_piv, (Bt, k), torch.int32)
    _check("rhs_T", rhs_T, (Bt, N, nb, r))
    _check("rhs_C", rhs_C, (Bt, k, r))
    if Bt == 0 or r == 0:
        raise ValueError(f"btb_solve: empty right-hand side "
                         f"{tuple(rhs_T.shape)}")
    lib = _lib()
    smem = lib.btb_solve_smem_bytes(nb, k, r)
    if smem > SMEM_LIMIT:
        raise ValueError(f"btb_solve: r={r} right-hand sides at nb={nb}, "
                         f"k={k} need {smem} bytes of shared memory, above "
                         f"the limit of {SMEM_LIMIT}")
    x = torch.empty_like(rhs_T)
    w = torch.empty_like(rhs_C)
    rc = lib.btb_solve_f64(
        fac.S_lu.data_ptr(), fac.S_piv.data_ptr(), fac.L.data_ptr(),
        fac.B.data_ptr(), fac.Tinv_B.data_ptr(), fac.Sb_lu.data_ptr(),
        fac.Sb_piv.data_ptr(), rhs_T.data_ptr(), rhs_C.data_ptr(),
        x.data_ptr(), w.data_ptr(), Bt, N, nb, k, r,
        torch.cuda.current_stream(rhs_T.device).cuda_stream)
    _raise_on(lib, rc, "btb_solve")
    LAUNCHES["btb_solve"] += 1
    return (x[..., 0], w[..., 0]) if single else (x, w)
