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
held on the other lanes' parity tests."""

from test_torch_constrained_common import check_iterate_parity
from test_torch_contact_leg import transcriptions
from test_torch_ipm_common import BENCH


def test_contact_leg_iterate_parity_structured():
    trj, trt = transcriptions()
    opts = dict(BENCH, kkt="structured",
                hessian_approximation="objective-only")
    check_iterate_parity(trj, trt, opts, 1e-5, lanes=2, scaled=False)
