"""IPM iterate parity with the JAX package on the double pendulum with its
elbow path constraint (mesh 8, Hermite-Simpson, B=4 jittered starts, the
bench's IPM options) under ``kkt="dense"`` (rtol 1e-6) and
``kkt="structured"`` (rtol 1e-5, each step from the JAX package's carry);
see ``test_torch_constrained_common.py``.
"""

import pytest

from opensim_moco_tpu import examples as jex
from opensim_moco_tpu_torch import examples as tex
from test_torch_constrained_common import check_iterate_parity

BENCH = dict(tol=3e-3, max_iter=200, bound_relax=1e-6, mu_init=1e-2,
             kappa_eps=100.0, acceptable_tol_factor=30.0, acceptable_iter=10,
             max_rescues=100)


@pytest.mark.parametrize("kkt,rtol,chained", [("dense", 1e-6, True),
                                              ("structured", 1e-5, False)])
def test_swingup_iterate_parity(kkt, rtol, chained):
    trj = jex.double_pendulum_swingup_study(8, with_path_constraint=True
                                            ).transcription()
    trt = tex.double_pendulum_swingup_study(8, with_path_constraint=True
                                            ).transcription()
    check_iterate_parity(trj, trt, dict(BENCH, kkt=kkt), rtol,
                         chained=chained)
