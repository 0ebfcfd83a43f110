"""The contact leg through the port's ``Track`` tool
(``examples.contact_leg_track_study``), port only: the JAX package's
compile of the leg takes minutes, and ``test_torch_contact_leg.py``
holds the leg's model and goals against it already.

Held: the markers' world positions from ``station_positions`` at the
reference poses against the numpy kinematics of ``contact_leg.py``
(1e-12), and the .trc text read back (its blank frames NaN, the rest
within 1e-15 of the largest position: mm to 17 digits, scaled to m);
the marker goal vanishing on the reference but in the blank frames; 50 mesh intervals by default; at mesh 5 the KKT structure of
``contact_leg_study`` (the periodicity rows in the border), the
goals in order, and finite c(z) and f(z) at the tool's guess."""

import io

import numpy as np
import torch

from opensim_moco_tpu_torch.example_models import contact_leg
from opensim_moco_tpu_torch.examples import (contact_leg_study,
                                             contact_leg_track_study)
from opensim_moco_tpu_torch.models import StationSpec
from opensim_moco_tpu_torch.utils.tables import read_trc

torch.set_num_threads(2)


def test_leg_markers_match_numpy_kinematics():
    study, _ = contact_leg_track_study(5)
    model = study.problem.model
    assert list(model.markers) == [m[0] for m in contact_leg.MARKERS]
    t, q, _ = contact_leg.reference()
    p = model.default_params("cpu")
    pos = model.mech.station_positions(
        p["mech"], torch.as_tensor(q),
        [StationSpec(n, b, tuple(loc)) for n, (b, loc) in
         model.markers.items()]).numpy()
    want = contact_leg.marker_positions(q)
    assert np.abs(pos - want).max() <= 1e-12 * np.abs(want).max()

    trc = read_trc(io.StringIO(contact_leg.marker_trc_text()))
    assert trc.metadata["Units"] == "mm"
    np.testing.assert_array_equal(trc.time, t)
    names = [m[0] for m in contact_leg.MARKERS]
    assert trc.marker_names == names + [contact_leg.UNUSED_MARKER[0]]
    blank = np.isnan(trc.positions).any(-1)
    k = names.index("SHANK")
    assert blank[:, k].sum() == len(contact_leg.BLANK_FRAMES)
    assert blank[list(contact_leg.BLANK_FRAMES), k].all()
    assert blank.sum() == len(contact_leg.BLANK_FRAMES)
    on = ~blank[:, :len(names), None]
    got = np.where(on, trc.positions[:, :len(names)], 0.0)
    assert np.abs(got - np.where(on, want, 0.0)).max() <= \
        1e-15 * np.abs(want).max()
    np.testing.assert_allclose(trc.positions[:, -1],
                               np.tile(contact_leg.UNUSED_MARKER[1],
                                       (len(t), 1)), rtol=1e-15)

    goal = study.problem.goals[1]
    assert goal.name == "marker_tracking" and list(goal.markers) == names
    y = torch.zeros(len(t), model.ny, dtype=torch.float64)
    y[:, :model.nq] = torch.as_tensor(q)
    v = goal.integrand(study.problem.create_rep(), torch.as_tensor(t), y,
                       None, None, p)
    gap = np.zeros(len(t), bool)
    gap[list(contact_leg.BLANK_FRAMES)] = True
    # SHANK's reference is interpolated linearly across its gap
    assert float(v[~gap].abs().max()) <= 1e-20
    assert 0.0 < float(v[gap].max()) <= 1e-5


def test_leg_track_study_default_mesh():
    """50 intervals: a marker blank at an end of the .trc, or a rounding
    of the mesh interval, would change the window or the count."""
    study, guess = contact_leg_track_study()
    assert study.solver_options.num_mesh_intervals == 50
    tr = study.transcription()
    assert len(guess) == tr.n
    assert tr.bounds()[0][:2].tolist() == [0.0, contact_leg.DURATION]


def test_leg_track_study_structure():
    study, guess = contact_leg_track_study(5)
    assert [g.name for g in study.problem.goals] == [
        "state_tracking", "marker_tracking", "effort", "periodicity",
        "grf_tracking"]
    opts = study.ipm_options
    assert (opts.tol, opts.max_iter, opts.mu_init,
            opts.hessian_approximation) == (1e-4, 2000, 1e-2,
                                            "objective-only")
    tr = study.transcription()
    nlp = tr.make_nlp("cpu")
    st, ref = nlp.structure, contact_leg_study(5).transcription(
        ).make_nlp("cpu").structure
    assert st is not None
    assert st.var_blocks == ref.var_blocks
    assert st.con_blocks == ref.con_blocks
    np.testing.assert_array_equal(st.border_vars, ref.border_vars)
    np.testing.assert_array_equal(st.border_cons, ref.border_cons)
    n_periodic = len(tr.rep.state_names) - 1
    assert list(st.border_cons) == list(range(nlp.m - n_periodic, nlp.m))
    z = torch.as_tensor(guess)
    assert torch.isfinite(nlp.constraints(z)).all()
    assert torch.isfinite(nlp.objective(z))
