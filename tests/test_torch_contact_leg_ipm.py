"""The planar contact leg at mesh 5 under ``kkt="structured"``, the port
against the JAX package on the CPU: ``init_fn`` and three chained
``body_fn`` steps from two jittered starts with the options
``chip_smoke.py`` phase 17 solves it with (the bench's, objective-only
curvature), every KKT factor and solve through K1's plain version (the
port's wrapper on CPU tensors) and the JAX package's ``btb``; per lane
within 1e-5 of the largest magnitude, mu and the counters equal
(``test_torch_ipm_common.py`` explains the tolerance). Unscaled: the JAX
package's gradient-based scaling takes its Jacobian's row norms from an
eager pass that takes two minutes on this model, and the scaling code is
held on the other lanes' parity tests.

Marked ``slow``: the JAX package's compile of its IPM step for this model
takes 265 s to 633 s of one test worker (489 s alone on an 8-core CPU),
the longest single test of the port. The chained structured steps stay
held by the other lanes' IPM parity tests
(``test_torch_ipm_structured.py``, ``test_torch_path_constraints_ipm.py``,
``test_torch_inverse.py``) and, on this lane, card against CPU by
``chip_smoke.py`` phase 18. Run it with ``-m slow``."""

import pytest

from test_torch_constrained_common import check_iterate_parity
from test_torch_contact_leg import transcriptions
from test_torch_ipm_common import BENCH


@pytest.mark.slow
def test_contact_leg_iterate_parity_structured():
    trj, trt = transcriptions()
    opts = dict(BENCH, kkt="structured",
                hessian_approximation="objective-only")
    check_iterate_parity(trj, trt, opts, 1e-5, lanes=2, scaled=False)
