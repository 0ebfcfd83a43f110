"""opensim_moco_tpu_torch: the PyTorch port of opensim_moco_tpu.

Module paths and public names mirror the JAX package
(``models/mech.py``, ``ocp/study.py``, ``solver/ipm.py``, ...); the JAX
package is the reference the port's tests hold it against. This package
imports ``torch`` and numpy only. Every function that makes tensors takes
a device and a dtype; the device is the CUDA card unless the caller asks
for the CPU.

* models     -> multibody mechanics, DGF muscles, force assembly
* transcribe -> direct collocation (Hermite-Simpson, trapezoidal)
* solver     -> batched interior-point NLP solver; dense or structured
                (block-tridiagonal) KKT
* ops, csrc  -> hand-written CUDA kernels (K1: the structured KKT factor
                and solve) and their wrappers
* ocp        -> goals, problem, study
* parallel   -> batched multistart solves
"""

from . import config

__version__ = "0.1.0"
