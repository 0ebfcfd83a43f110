"""opensim_moco_tpu_torch: the PyTorch port of opensim_moco_tpu.

Module paths and public names mirror the JAX package
(``models/mech.py``, ``ocp/study.py``, ``solver/ipm.py``, ...); the JAX
package is the reference the port's tests hold it against. This package
imports ``torch`` and numpy only. Every function that makes tensors takes
an explicit device and dtype.

* models     -> multibody mechanics, DGF muscles, force assembly
* transcribe -> direct collocation (Hermite-Simpson, trapezoidal)
* solver     -> batched interior-point NLP solver (dense KKT path)
* ocp        -> goals, problem, study
* parallel   -> batched multistart solves
"""

from . import config

__version__ = "0.1.0"
