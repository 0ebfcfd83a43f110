"""Parity of the port's solution files against the JAX package, on the
CPU: ``utils/tables.py`` ``trajectory_to_sto`` and ``sto_to_trajectory``.

The same ``Solution`` (or ``Trajectory``), drawn with numpy from a fixed
seed, with multipliers, derivatives and parameters, goes through each
package's writer. Held: the two files are equal byte for byte (the
reference's solution layout, the header statistics, 17 significant
digits, the multipliers negated), for success true and false and for a
trajectory without statistics; each package's reader takes the other's
file to the same arrays and names (the columns classified by their path
suffixes, the multipliers negated back).
"""

import numpy as np
import pytest

from opensim_moco_tpu.utils import tables as jtables
from opensim_moco_tpu.utils import trajectory as jtraj
from opensim_moco_tpu_torch.utils import tables as ttables
from opensim_moco_tpu_torch.utils import trajectory as ttraj


def solution(mod, success=True, seed=0, solution=True):
    """A seeded solution of a model with a muscle, a coupler and an
    implicit tendon: every column kind the reader sorts."""
    rng = np.random.default_rng(seed)
    G = 7
    states = ["/jointset/j/q/value", "/jointset/j/q/speed",
              "/forceset/m/activation", "/forceset/m/normalized_tendon_force"]
    controls = ["/forceset/m", "/forceset/reserve"]
    mults = ["lambda_cid0_p0", "/coupler/multiplier_1"]
    derivs = ["/jointset/j/q/accel",
              "/forceset/m/implicitderiv_normalized_tendon_force",
              "/forceset/x_derivative"]
    kw = dict(time=np.sort(rng.uniform(0.0, 1.0, G)),
              state_names=states, states=rng.normal(size=(G, 4)),
              control_names=controls, controls=rng.uniform(0, 1, (G, 2)),
              multiplier_names=mults, multipliers=rng.normal(size=(G, 2)),
              derivative_names=derivs, derivatives=rng.normal(size=(G, 3)),
              parameter_names=["mass"], parameters=np.array([1.25]))
    if not solution:
        return mod.Trajectory(**kw)
    return mod.Solution(
        **kw, success=success,
        status="converged" if success else "max iterations or stall "
        "(kkt=3.10e-02)", objective=float(rng.normal()),
        num_iterations=17, solver_duration=1.0 / 3.0, kkt_error=1e-7)


def _same(a, b):
    for name in ("time", "states", "controls", "multipliers", "derivatives"):
        np.testing.assert_array_equal(getattr(a, name),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)
    for name in ("state_names", "control_names", "multiplier_names",
                 "derivative_names"):
        assert list(getattr(a, name)) == list(getattr(b, name)), name
    assert (a.success, a.status) == (b.success, b.status)
    np.testing.assert_array_equal(a.objective, b.objective)


@pytest.mark.parametrize("kind", ["success", "failure", "trajectory"])
def test_writer_bytes_and_readers_match_jax(tmp_path, kind):
    args = dict(success=kind == "success", solution=kind != "trajectory")
    port, ref = tmp_path / "port.sto", tmp_path / "jax.sto"
    ttables.trajectory_to_sto(solution(ttraj, **args), str(port))
    jtables.trajectory_to_sto(solution(jtraj, **args), str(ref))
    assert port.read_bytes() == ref.read_bytes()
    # each reader on the other's file, against the other reader
    _same(ttables.sto_to_trajectory(str(ref)),
          jtables.sto_to_trajectory(str(port)))
    back = ttables.sto_to_trajectory(str(port))
    orig = solution(ttraj, **args)
    np.testing.assert_array_equal(back.multipliers, orig.multipliers)
    np.testing.assert_array_equal(back.derivatives, orig.derivatives)
    assert isinstance(back, ttraj.Solution)
    assert back.success == (kind != "failure")
