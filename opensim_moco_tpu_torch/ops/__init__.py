"""Hand-written CUDA kernels of the port, each beside its wrapper.

* ``btb``: K1, the batched bordered block-tridiagonal KKT factor and solve
  (``csrc/btb.cu``).

Sources are compiled with ``nvcc`` at first use (``_build.py``); importing
this package builds nothing.
"""
