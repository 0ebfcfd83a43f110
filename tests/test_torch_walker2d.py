"""The planar walker of ``example_models/walker2d.py`` and its ``Track``
study (``examples.walker2d_track_study``), port only, on the CPU: the
reference against gait2d's bounds and the half-cycle symmetry, the stance
foot's indentation, the ground reaction forces against the pelvis's
motion, the muscles' moment arms, the symmetry rows' pairs and the
study's KKT structure at gait2d's 50 intervals (the 38 symmetry rows make
K1's border), and at mesh 3 the compressed Jacobian blocks and the
objective's Hessian blocks (the curvature ``Track`` solves with) against
the port's own dense ``torch.func`` derivatives (relative 1e-10 of the
largest magnitude). The JAX package's parity is in
``test_torch_walker2d_jax.py``.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, jacfwd

from opensim_moco_tpu_torch.example_models import walker2d
from opensim_moco_tpu_torch.examples import (_gait2d_state_bounds,
                                             _gait2d_symmetry_goal,
                                             walker2d_track_study)
from opensim_moco_tpu_torch.models import MechModelBuilder, muscle
from opensim_moco_tpu_torch.models.model import Model
from opensim_moco_tpu_torch.solver import structured as ts
from opensim_moco_tpu_torch.solver.kkt import CompiledStructure
from opensim_moco_tpu_torch.utils.splines import CubicSpline

PATH = {c: walker2d.coordinate_path(c) for c in walker2d.COORDS}


class _Bounds:
    """Records ``set_state_info`` calls, as a ``Problem`` takes them."""

    def __init__(self):
        self.info = {}

    def set_state_info(self, name, bounds, *args):
        self.info[name] = bounds


def _model():
    return walker2d.build_walker(MechModelBuilder, Model, CubicSpline, muscle)


def test_reference_inside_gait2d_bounds():
    rec = _Bounds()
    _gait2d_state_bounds(rec)
    t, q = walker2d.reference()
    T = walker2d.HALF_CYCLE
    assert t[0] == -0.5 * T and t[-1] == 1.5 * T
    window = (t >= 0.0) & (t <= T)
    assert window.sum() == (len(t) + 1) // 2
    t, q = t[window], q[window]
    assert set(rec.info) == {f"{p}/value" for p in PATH.values()}
    for k, c in enumerate(walker2d.COORDS):
        lo, hi = rec.info[f"{PATH[c]}/value"]
        assert lo < q[:, k].min() and q[:, k].max() < hi, c
    speed = np.diff(q[:, 1]) / np.diff(t)
    np.testing.assert_allclose(speed, walker2d.SPEED, rtol=1e-12)


def test_reference_half_cycle_symmetry():
    """Each symmetry pair (initial of the first = final of the second)
    holds on the reference's values and, by central differences, its
    speeds; pelvis_tx's value is the one coordinate left out."""
    goal = _gait2d_symmetry_goal(_model())
    T, h = walker2d.HALF_CYCLE, 1e-5
    q0, qT = walker2d.pose(0.0), walker2d.pose(T)
    u0 = (walker2d.pose(h) - walker2d.pose(-h)) / (2 * h)
    uT = (walker2d.pose(T + h) - walker2d.pose(T - h)) / (2 * h)
    index = {f"{PATH[c]}/{kind}": (k, kind)
             for k, c in enumerate(walker2d.COORDS)
             for kind in ("value", "speed")}
    coords = [(a, b) for a, b, _ in goal.state_pairs if a in index]
    assert len(coords) == 19
    assert f"{PATH['pelvis_tx']}/value" not in {a for a, _ in coords}
    for a, b in coords:
        (i, kind), (j, _) = index[a], index[b]
        if kind == "value":
            assert abs(q0[i] - qT[j]) <= 1e-12, (a, b)
        else:
            assert abs(u0[i] - uT[j]) <= 1e-6, (a, b)


def test_symmetry_pairs_by_name():
    """Left and right swap by name and nothing else: every path has one
    ``_r`` or ``_l``, at its end, or none."""
    model = _model()
    goal = _gait2d_symmetry_goal(model)
    states = set(model.state_names())
    assert len(goal.state_pairs) == 37 and len(goal.control_pairs) == 1
    swap = {"r": "l", "l": "r"}
    for a, b, negate in goal.state_pairs:
        assert not negate and a in states and b in states
        leaf, other = a.split("/")[-2], b.split("/")[-2]
        if leaf[-2:] in ("_r", "_l"):
            assert other == leaf[:-1] + swap[leaf[-1]]
            assert a.count("_r") + a.count("_l") == \
                (2 if not a.endswith("activation") else 1)
        else:
            assert a == b
    sides = {a.split("/")[2] for a, _, _ in goal.state_pairs
             if "activation" in a}
    assert len(sides) == 18
    assert goal.control_pairs == (("/forceset/lumbarAct",
                                   "/forceset/lumbarAct", False),)


def test_stance_foot_indentation():
    """The lower foot's lowest sphere is INDENTATION into the ground at
    every reference sample, and the other foot no lower."""
    t, q = walker2d.reference()
    low = np.stack([walker2d.lowest_points(x) for x in q])
    np.testing.assert_allclose(low.min(1), -walker2d.INDENTATION,
                               rtol=0, atol=1e-12)
    assert (low.max(1) >= -walker2d.INDENTATION - 1e-12).all()
    low = low[(t >= 0.0) & (t <= walker2d.HALF_CYCLE)]
    # the window is the right foot's stance (heel strike to the left
    # foot's heel strike) and the left foot's toe-off and swing
    np.testing.assert_allclose(low[:, 0], -walker2d.INDENTATION, rtol=0,
                               atol=1e-12)
    assert low[0, 1] < -walker2d.INDENTATION + 1e-12
    assert (low[:, 1] > 0.01).any()


def test_grf_against_pelvis_acceleration():
    """The two feet's vertical forces sum to m (g + y''), y'' from central
    differences of the reference's pelvis height; the other components
    are 0 and each foot carries its stance weight."""
    grf = walker2d.grf_reference()
    t_r, f_r = grf["Right_GRF"]
    t_l, f_l = grf["Left_GRF"]
    t, q = walker2d.reference()
    np.testing.assert_array_equal(t_r, t)
    np.testing.assert_array_equal(t_l, t)
    h = 1e-4
    ty = np.array([[walker2d.pose(tk + d)[2] for d in (-h, 0.0, h)]
                   for tk in t])
    acc = (ty[:, 0] - 2 * ty[:, 1] + ty[:, 2]) / h ** 2
    weight = walker2d.TOTAL_MASS * 9.81
    np.testing.assert_allclose(f_r[:, 1] + f_l[:, 1],
                               weight + walker2d.TOTAL_MASS * acc,
                               rtol=0, atol=1e-4 * weight)
    assert not f_r[:, [0, 2]].any() and not f_l[:, [0, 2]].any()
    np.testing.assert_allclose(
        walker2d.stance_weight(t, "r") + walker2d.stance_weight(t, "l"), 1.0,
        rtol=0, atol=1e-12)
    assert f_r[:, 1].min() >= 0.0 and f_l[:, 1].min() >= 0.0


# sign of each muscle's moment arm (-dL/dq) about the hip (flexion
# positive), knee (extension positive) and ankle (dorsiflexion positive);
# 0 where it does not cross the joint
ARMS = {"hamstrings": (-1, -1, 0), "bifemsh": (0, -1, 0),
        "glut_max": (-1, 0, 0), "iliopsoas": (1, 0, 0),
        "rect_fem": (1, 1, 0), "vasti": (0, 1, 0), "gastroc": (0, -1, -1),
        "soleus": (0, 0, -1), "tib_ant": (0, 0, 1)}


def test_muscle_moment_arms():
    """Over the reference stride every muscle pulls its joints the way its
    anatomy says, with an arm of at least 1 cm."""
    assert [m[0] for m in walker2d.MUSCLES] == list(ARMS)
    sign = np.array(list(ARMS.values()))
    base = walker2d.mean_pose()
    e = 1e-6
    for phi in np.linspace(0, 1, 20, endpoint=False):
        q = base.copy()
        q[3:6] = walker2d.right_leg(phi)
        arms = []
        for j in range(3):
            qp, qm = q.copy(), q.copy()
            qp[3 + j] += e
            qm[3 + j] -= e
            arms.append(-(walker2d.path_lengths(qp) -
                          walker2d.path_lengths(qm)) / (2 * e))
        arms = np.stack(arms, 1)
        assert (arms * sign >= 0.01 * np.abs(sign)).all(), phi
        assert (np.abs(arms[sign == 0]) < 1e-9).all(), phi


def test_walker_model_layout():
    model = _model()
    assert model.coordinate_paths() == [PATH[c] for c in walker2d.COORDS]
    assert [m.name for m in model.muscles] == [
        f"{name}_{s}" for s in walker2d.SIDES for name, _, _ in
        walker2d.MUSCLES]
    assert model.control_names()[:4] == [
        f"/forceset/{c}_actuator" for c in walker2d.RESIDUALS] + [
        "/forceset/lumbarAct"]
    assert (model.ny, model.nx) == (38, 22)
    names = [c.name for c in model.sphere_contacts]
    assert names == ["contactHeel_r", "contactFront_r", "contactHeel_l",
                     "contactFront_l"]


@pytest.fixture(scope="module")
def study50():
    return walker2d_track_study(50)


def test_walker_track_study_structure(study50):
    """gait2d's 50 intervals over the half cycle; K1's border is the 38
    symmetry rows, the last rows of c; the guess is the filtered
    reference within the bounds."""
    study, guess = study50
    tr = study.transcription()
    assert tr.n_int == 50
    assert tr.bounds()[0][:2].tolist() == [0.0, walker2d.HALF_CYCLE]
    nlp = tr.make_nlp("cpu")
    st = nlp.structure
    assert list(st.border_cons) == list(range(nlp.m - 38, nlp.m))
    cs = CompiledStructure(st.var_blocks, st.con_blocks, st.border_vars,
                           st.border_cons, nlp.n, nlp.m)
    lb, ub = tr.bounds()
    # the border's variables are the two fixed times, which the solver
    # eliminates
    assert (lb[st.border_vars] == ub[st.border_vars]).all()
    cs = cs.remap_free(np.nonzero(~(np.isfinite(lb) & (lb == ub)))[0])
    assert len(cs.bv) == 0 and len(cs.bc) == 38
    assert (cs.N, cs.nv + cs.nc) == (50, 278)
    assert ((guess >= lb) & (guess <= ub)).all()
    c = nlp.constraints(torch.as_tensor(guess))
    goal = study.problem.goals[[g.name for g in study.problem.goals].index(
        "symmetry")]
    assert goal.num_outputs == 38
    # the symmetry rows on the filtered reference: the pairs of
    # coordinates and speeds nearly hold, the activations' exactly
    rows = c[-38:].numpy()
    assert np.abs(rows[19:]).max() == 0.0
    assert np.abs(rows[:19]).max() < 0.05


def test_walker_blocks_against_dense_autodiff():
    """At mesh 3, at the guess plus 5% of the bounds' widths of jitter: the
    compressed J blocks (constraints gradient-scaled as the IPM scales
    them) and the objective's H blocks against dense forward-mode
    derivatives."""
    study, guess = walker2d_track_study(3)
    tr = study.transcription()
    nlp = tr.make_nlp("cpu")
    st = nlp.structure
    lb, ub = tr.bounds()
    rng = np.random.default_rng(0)
    width = np.where(np.isfinite(ub - lb), ub - lb, 1.0)
    Z = torch.as_tensor(np.clip(
        guess + 0.05 * width * rng.uniform(-1, 1, guess.shape), lb, ub))[None]
    J0 = jacfwd(nlp.constraints)(Z[0])
    c_scale = torch.clamp(100.0 / torch.clamp(J0.abs().amax(1), min=1e-8),
                          max=1.0)

    def c_fn(zz):
        return c_scale * nlp.constraints(zz)

    def f_grad(zz, nn):
        return grad(lambda q: nlp.objective(q).sum())(zz)

    bd = ts.BlockDerivatives(CompiledStructure(
        st.var_blocks, st.con_blocks, st.border_vars, st.border_cons, nlp.n,
        nlp.m), c_fn, "cpu")
    nu = torch.zeros(1, nlp.m, dtype=Z.dtype)
    J = ts.dense_J_from_blocks(bd.jac_blocks(Z), bd.ix)[0]
    H = ts.dense_H_from_blocks(bd.hess_blocks(f_grad, Z, nu), bd.ix)[0]
    J_ref = jacfwd(c_fn)(Z[0])
    H_ref = jacfwd(grad(nlp.objective))(Z[0])
    assert (J - J_ref).abs().max() <= 1e-10 * J_ref.abs().max()
    assert (H - H_ref).abs().max() <= 1e-10 * H_ref.abs().max()


@pytest.mark.parametrize("lanes", [1, 3])
def test_seed_chunks_match_one_pass(monkeypatch, lanes):
    """On a large grid the seeded tangents go through in chunks of
    ``SEED_LANES // B`` seeds (at least ``SEED_CHUNK``); chunked, they equal
    one pass over every seed and the dense Jacobian times the seeds."""
    rng = np.random.default_rng(1)
    z = torch.as_tensor(rng.standard_normal((lanes, 30)))
    seeds = torch.as_tensor(rng.standard_normal((40, 30)))

    def fn(zz):
        return torch.sin(zz) * zz.roll(1, -1) + zz.cumsum(-1)

    monkeypatch.setattr(ts, "SEED_LANES", 24)
    chunked = ts._seeded_jvp(fn, z, seeds, 50)  # 24 (B=1) or 16 (B=3)
    whole = ts._seeded_jvp(fn, z, seeds, 1)
    dense = torch.stack([jacfwd(fn)(zk[None])[0, :, 0] @ seeds.T
                         for zk in z]).transpose(1, 2)
    assert chunked.shape == (lanes, 40, 30)
    assert (chunked - whole).abs().max() == 0.0
    assert (chunked - dense).abs().max() <= 1e-12 * dense.abs().max()
