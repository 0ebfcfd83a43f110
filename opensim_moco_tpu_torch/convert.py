"""Carry numbers from host arrays into the port's tensors.

``params_from_numpy`` turns a parameter tree of numpy arrays into the
port's parameter dict. It accepts the port's own ``Model.numpy_params()``
and, equally, the JAX package's ``Model.default_params()`` after
``jax.device_get`` (the same keys and shapes), so both packages can be
evaluated on identical numbers. ``problem_layout_from_numpy`` does the
same for a transcription's offsets, bounds and a decision vector.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device


def params_from_numpy(tree, device, dtype=torch.float64):
    """Nested dict of array-likes -> nested dict of tensors on ``device``.

    Floating arrays take ``dtype``; integer and bool arrays keep theirs."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, dev, dtype) for k, v in tree.items()}
    arr = np.array(tree)  # a writable copy (device_get gives read-only)
    if arr.dtype.kind == "f":
        return torch.as_tensor(arr, dtype=dtype, device=dev)
    return torch.as_tensor(arr, device=dev)


def problem_layout_from_numpy(offsets, lb, ub, z, device,
                              dtype=torch.float64):
    """Transcription layout on ``device``: ``offsets`` as plain
    ``(start, stop)`` ints per block, ``lb``/``ub``/``z`` as tensors."""
    dev = resolve_device(device)
    return {
        "offsets": {k: (int(a), int(b)) for k, (a, b) in offsets.items()},
        "lb": torch.as_tensor(np.asarray(lb), dtype=dtype, device=dev),
        "ub": torch.as_tensor(np.asarray(ub), dtype=dtype, device=dev),
        "z": torch.as_tensor(np.asarray(z), dtype=dtype, device=dev),
    }
