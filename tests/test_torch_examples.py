"""The JAX package's ``test_examples.py`` problems through the PyTorch
port's ``Study.solve`` on the CPU, with the same analytic checks."""

import numpy as np
import pytest
import torch

from opensim_moco_tpu_torch import examples as tex

torch.set_num_threads(2)


def test_sliding_mass_min_time():
    """Bang-bang analytic optimum: tf = 2 sqrt(d m / F) = 0.4 s (the JAX
    package's test_examples.py, through the port)."""
    study = tex.sliding_mass_study(50, "trapezoidal")
    sol = study.solve("cpu")
    assert sol.success, sol.status
    assert abs(sol.final_time - 0.4) < 2e-3
    u = sol.control("/forceset/actuator")
    assert u[2] > 45.0
    assert u[-3] < -45.0


def test_hanging_muscle_min_time_rigid_tendon():
    """``test_examples.py::test_hanging_muscle_min_time_rigid_tendon``
    through the port's ``Study.solve``."""
    study = tex.hanging_muscle_study(25, ignore_tendon_compliance=True,
                                     ignore_activation_dynamics=True)
    study.set_ipm_options(tol=1e-4, max_iter=400)
    sol = study.solve("cpu")
    assert sol.success, sol.status
    # analytic two-phase estimate: pull at ~Fmax then brake on gravity
    # gives tf ~= 0.051 s
    assert 0.048 < sol.final_time < 0.06
    h = sol.state("/jointset/joint/height/value")
    assert abs(h[0] - 0.15) < 1e-6
    assert abs(h[-1] - 0.14) < 1e-6
    assert np.isfinite(sol.objective) and sol.num_iterations > 0


def test_study_requires_a_device(monkeypatch):
    """``Study.solve`` runs on the card unless the caller asks for the CPU;
    without a card it raises (no CPU fallback)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    study = tex.sliding_mass_study(5)
    for args in ((), (None,), ("cuda",)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            study.solve(*args)
