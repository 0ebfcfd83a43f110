"""Device and dtype handling for the PyTorch port.

Every builder that creates tensors takes a ``torch.device`` and a
``torch.dtype``. The device defaults to the CUDA card; the CPU is used only
when the caller asks for it, and nothing falls back to the CPU when the
card is missing. The solver runs in float64 by default, the precision the
JAX package's tests and CPU solves use.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device`` (a device, or a string such as
    ``"cpu"``; None means the default, ``"cuda"``). Raises when a CUDA
    device is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available")
    return dev


@contextlib.contextmanager
def full_precision(device):
    """Disable TF32 for matmuls and cuDNN inside the block on CUDA.

    Mirrors the JAX solver's pinned full-precision matmul
    (``jax.default_matmul_precision("highest")``): reduced-precision
    products poison IPM Jacobians and Newton systems. The previous flags
    are restored on exit. A no-op on other devices."""
    dev = torch.device(device)
    if dev.type != "cuda":
        yield
        return
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
