"""The six-muscle arm's inverse (``inverse_arm.py``) at mesh_interval 0.1
under ``kkt="structured"``, the port against the JAX package on the CPU:
``init_fn`` and three ``body_fn`` steps from four jittered starts with the
tool's IPM options, every KKT factor and solve through K1's plain version
(the port's wrapper on CPU tensors) and the JAX package's ``btb``; per lane
within 1e-5 (``test_torch_ipm_common.py`` explains the tolerance), mu and
the counters equal."""

from test_torch_constrained_common import check_iterate_parity
from test_torch_inverse_common import inverses


def test_arm_inverse_iterate_parity_structured():
    ij, it = inverses("arm", 0.1)
    sj, st = ij.build_study(), it.build_study()
    o = st.ipm_options
    opts = dict(tol=o.tol, max_iter=o.max_iter, mu_init=o.mu_init,
                hessian_approximation=o.hessian_approximation,
                kkt="structured")
    check_iterate_parity(sj.transcription(), st.transcription(), opts, 1e-5)
