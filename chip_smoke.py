"""Drive the PyTorch port's main path once on one CUDA card.

The main path is a batched interior-point solve of the hanging-muscle
minimum-time problem (a DeGrooteFregly2016 muscle lifting a 0.5 kg mass)
through ``opensim_moco_tpu_torch.parallel.make_batched_solver``, in
float64, at the bench configuration: Hermite-Simpson at 25 mesh
intervals, 32 jittered starts, the bench's IPM options. So that the whole
script stays under 20 minutes, the bench's ``max_iter`` of 200 is cut to
40 (phases 2-9), 50 (phase 5), 15 (phase 11: no lane converges under
chol-schur) and 3 (phase 17: its lanes' convergence is recorded, not
held; phase 19 solves the same leg to convergence through ``Track``),
``Track``'s 2000 to 200 (phase 19), 5 (phase 20: its convergence is
reported, not held), the JAX bench's gait2d lane's 250 to
``WALKER_MAX_ITER`` (phase 22: lane 0 converges in 90), the JAX
package's gait2d prediction's 1000 to ``WALKER_PREDICT_MAX_ITER`` (phase
24: its convergence is reported, not held), the ``Inverse`` tool's 2000
to ``WALKER_INVERSE_MAX_ITER`` (phase 27), and the walker's ``Track``
study's 250 to ``WALKER_STUDY_MAX_ITER`` (phase 31); the card-against-CPU
checks of phases 18, 21, 23 and 25 take 2 steps in place of 3; and K1's
checks on Newton systems above ``LARGE_KKT_DIM`` rows time the kernels
over 10 calls and the plain and library versions over 1, after a
warm-up call: a lane left at ``max_iter`` holds its batch to the end,
and a library LU of the walker inverse's 8 lanes takes 7 s.

Phases, one report line each:

1. device: the card's name and power limit; no card, no run. Then the
   hand-written kernels are built from ``opensim_moco_tpu_torch/csrc``;
2. full-dynamics lane (activation + implicit tendon compliance),
   ``kkt="dense"``, B=8 (the first 8 of the 32 starts): converged,
   strict, mean/max iterations, wall seconds;
3. card against CPU, iterate level, ``kkt="dense"``: ``init_fn`` and 3
   ``body_fn`` steps on both devices for the same 32 lanes; z, nu, wL and
   wU agree per lane to 1e-6 of their magnitude, mu and the iteration
   counters exactly;
4. card against CPU, solve level (lanes 0-3, ``kkt="dense"``): every lane
   that converges on the CPU converges on the card, objectives within
   relative 1e-2;
5. simplified lane (rigid tendon, no activation dynamics), B=8,
   ``kkt="dense"``;
6. full-dynamics lane under ``kkt="auto"`` (the JAX bench's own mode:
   compressed derivatives, dense LU below n+m = 1200, the least-squares
   multiplier start through K1), B=32, with K1's launch counts;
7. full-dynamics lane under ``kkt="structured"`` (every KKT factor and
   solve through K1), B=32, with K1's launch counts; every lane of phase
   2 that converges under both ``"dense"`` and ``"structured"`` has
   objectives within relative 1e-2;
8. K1 against its plain PyTorch version on the card, with times: (a) the
   KKT blocks the structured lane factors in its first iteration (B=32,
   N=25, nb=34, k=1), factor then a 3-column solve and a 1-column solve
   in the main path's form; (b) random well-conditioned blocks, B=8,
   N=16, nb=200, k=4 (the device-memory mode), factor then a 3-column
   solve; (c) a lane with a singular block gives non-finite output and no
   exception, in both memory modes; (d) every shape of a sweep that
   crosses the kernel's tile, panel and memory-mode edges
   (``ops.btb.EDGE_SHAPES``), each with 1, 2 and 9 right-hand sides,
   agrees lane by lane, B=2. The lines of (a) and (b) also give the
   factor's and the solve's barrier phases as the code reckons them
   (``_factor_barriers``, ``_solve_barriers``);
9. card against CPU, iterate level, under ``kkt="structured"``.

The constrained problems, each on its own path through K1:

10. the double-pendulum swing-up with its elbow path constraint
    (``double_pendulum_swingup_study(25, with_path_constraint=True)``,
    path slacks in K1's blocks), B=32, the bench's IPM options,
    ``kkt="structured"``, with n, m and K1's shape; then K1 against its
    plain version on this lane's first Newton blocks, factor and a
    1-column solve, with times;
11. the same lane under ``kkt="dense"`` with
    ``dense_factorization="chol-schur"``, B=8; lanes that converge in
    both phases 10 and 11 have objectives within relative 1e-2 (the
    Cholesky of H + Sigma + delta I needs the whole Hessian block
    positive definite: on this non-convex problem the JAX package's
    chol-schur converges no lane either);
12. Kirk's minimum-effort problem (the generalized spring), mesh 50,
    tol 1e-7, B=8, ``kkt="structured"``: converged lanes within 1e-5 of
    the analytic states;
13. the coupler-constrained double pendulum (multipliers and velocity
    corrections in K1's blocks; mesh 15: |q1 - q0| <= 1e-6) and the
    oscillator mass with its half-period endpoint constraint (the
    parameter and the row in K1's border, k = 2; mesh 40:
    |m - 1| <= 1e-3), each B=8, ``kkt="structured"``, then K1 against its
    plain version on each lane's first Newton blocks;
14. card against CPU, iterate level, ``kkt="structured"``, for the lanes
    of phases 10 and 13 (the coupler): each of 3 steps taken on the CPU
    from the card's carry agrees in z, nu, wL and wU to 1e-6, and 3
    chained steps on each device give the same mu and counters. (The
    swing-up's chained iterates drift apart to about 1.6e-6 in three
    steps: its first Newton system already gives solutions 3e-8 apart
    between K1 and the plain version, as between the plain version and
    the library LU, and the next steps amplify that.)

The inverse (prescribed-kinematics) problems, through the ``Inverse``
tool's options (``objective-only`` curvature, no control-midpoint rows,
the implicit-derivative penalty) with ``max_iter`` cut from the tool's
2000 to 300, so that a stalled lane does not hold the batch:

15. the hanging-muscle inverse (``examples.hanging_muscle_inverse(0.02)``:
    activation dynamics, an implicit compliant tendon and a reserve,
    folded force balance), B=32, under ``kkt="dense"`` and then
    ``"structured"``, with K1's launches; lanes that converge in both
    modes have objectives within relative 1e-2; then K1 against its
    plain version on this lane's first Newton blocks;
16. the six-muscle arm's inverse (``tests/inverse_arm.py``, mesh interval
    0.02), B=32, ``kkt="auto"``, which routes every factor and solve
    through K1 (n+m >= 1200; nb > 64, so the wide solve kernel), with the
    largest reserve control of the converged lanes; K1 against its plain
    version on its first Newton blocks; K1's times on random blocks at
    the arm's inner block width and at the width every block is padded
    to (its last block carries the final mesh point); and card against
    CPU for lanes 0-3 as in phase 14 (each of 3 steps alone on the CPU
    from the card's carry within 1e-6, mu and the counters exact after 3
    chained steps).

The gait-model parts (custom joints, smooth sphere contact, the gait
goals), on the planar contact leg of ``example_models/contact_leg.py``
(``examples.contact_leg_study(50)``: a squat tracked with
``StateTrackingGoal``, ``ContactTrackingGoal`` and an effort goal, the
``PeriodicityGoal`` rows in K1's border):

17. the contact leg, B=32, the bench's IPM options with
    ``objective-only`` curvature (as the JAX bench's gait2d lane),
    ``kkt="structured"`` (every factor and solve through K1), with n, m,
    K1's shape (N, the padded nb, the inner blocks' width and k) and
    launches (at ``max_iter`` 3 no lane converges: the count is
    reported, not held); then K1 against its plain version on this
    lane's first Newton blocks;
18. card against CPU for lanes 0-3 of phase 17 as in phase 14 (each of 2
    steps alone on the CPU from the card's carry within 1e-6, mu and the
    counters exact after 2 chained steps).

The ``Track`` tool (MocoTrack), with its own IPM options (tol 1e-4,
``mu_init`` 1e-2, ``objective-only`` curvature) and ``max_iter`` cut from
the tool's 2000 to 200:

19. ``Track.solve()`` on the card for the point mass of
    ``tests/test_track.py`` (the JAX test's recovery of its motion and
    control); then the contact leg through ``Track``
    (``examples.contact_leg_track_study(50)``: the coordinates from a
    low-passed ``StoTable`` with derived speeds, six markers from a .trc,
    and the leg's effort, periodicity and GRF goals), B=32: lane 0 the
    tool's ``make_guess``, lanes 1-31 that guess plus the jitter of
    ``batch_guesses(tr, 32, scale=0.05, seed=0)``, clipped to the bounds
    (``_track_starts``), ``kkt="structured"``, with n, m, K1's shape and
    launches; then K1 against its plain version on this lane's first
    Newton blocks;
20. the same lane with ``hessian_approximation="exact"``, lanes 0-7,
    ``max_iter`` 5: lanes, strict lanes, iterations and final KKT
    errors, reported, not gated (it fails on a non-finite iterate or a K1
    disagreement on its first Newton blocks only);
21. card against CPU for lanes 0-3 of phase 19 as in phase 14 (each of 2
    steps alone on the CPU from the card's carry within 1e-6, mu and the
    counters exact after 2 chained steps).

The planar 18-muscle walker of ``example_models/walker2d.py`` through
``Track`` (``examples.walker2d_track_study(50)``: gait2d's tracking
set-up, with the 38 half-cycle symmetry rows in K1's border and the two
feet's GRF tracking), solved with the options of the JAX bench's gait2d
lane (``bench.py:105-110``: tol 1e-4, ``kappa_eps`` 100, acceptable at 30
tol for 5 iterations, 6 line-search trials, objective-only curvature),
its ``max_iter`` of 250 cut to ``WALKER_MAX_ITER``:

22. the walker's lane, B = ``WALKER_B``: lane 0 the tool's
    ``make_guess``, the others that guess plus ``batch_guesses``'s jitter
    (``_track_starts``), ``kkt="structured"``, with n, m, K1's shape and
    launches, every lane's iterations and final KKT error, and the
    coordinates' RMS distance from the filtered reference of the
    converged lanes; lane 0 converges (the jittered lanes' KKT errors
    start 5e4 to 1.4e5 times lane 0's and run to the cap; the K1 check
    below gives each lane's KKT error at its start). Then K1
    against its plain version on this lane's first Newton blocks;
23. card against CPU for lanes 0-1 of phase 22 as in phase 14, with 2
    steps (each step alone on the CPU from the card's carry within 1e-6,
    mu and the counters exact after 2 chained steps).

The walker's de-novo prediction (``examples.walker2d_prediction_study(10)``:
the JAX package's ``gait2d_prediction_study`` on the walker, a free final
time in [0.4, 0.6], the symmetry rows, the center of mass's average speed
held at 1.2 m/s, the cubed effort over its displacement, which sends the
problem to the dense KKT path), warm-started from a tracking solution as
the reference warm-starts it: phase 22's lane 0 (mesh 50) as the
``Solution`` that ``Study.solve`` makes of it (``Study.expand``), resampled
onto the mesh-10 grid (quintic, ``guess_from_trajectory``); without phase
22, the walker's ``Track`` study at mesh 10, solved first from
``make_guess`` with phase 22's options (``Track.solve`` would solve the
tool's own goals without the symmetry rows and the GRF tracking):

24. ``Study.solve(guess=solution)`` on the card, B=1, the study's options
    (tol 1e-4, objective-only curvature) with ``max_iter``
    ``WALKER_PREDICT_MAX_ITER``: n, m, the route (no KKT structure; K1's
    launch counts, held at 0), iterations, final KKT error, convergence,
    objective, final time, the center of mass's average forward speed,
    the largest symmetry-row residual, seconds per iteration and the
    card's peak memory (the solver reports its best iterate). Held: the
    dense route, a finite iterate and the final time in [0.4, 0.6];
    convergence is reported, not held (the JAX package's own prediction
    stalls from a mesh-10 tracking start);
25. card against CPU on phase 24's problem from its warm start, dense,
    B=1, 2 steps, as in phase 23;
26. the seven tracking and output goals (``tests/tracking_goals_model.py``:
    a body on a custom joint with three rotations and a forearm, all eight
    goals as costs at mesh 4, the model of the CPU goal test): f, its
    gradient, the compressed J blocks and the exact Lagrangian's H blocks
    (the acceleration goal's nested forward mode through the forward
    dynamics under the Hessian pass) on the card against the CPU at two
    points, within 1e-10.

The walker's MocoInverse (``examples.walker2d_inverse_study(0.01)``: the
JAX package's ``gait_inverse_study`` set-up, whose subject files are not
in the repository, on the walker's wrapping variant: cylinder wraps on
the vasti and the gastrocnemius, rect_fem's moving insertion and
bifemsh's conditional point; no spheres, the measured GRFs applied as
external loads from an ExternalLoads XML and .mot through
``ModOpAddExternalLoads``; implicit compliant tendons, no passive fiber
force, reserves on the six leg coordinates; every coordinate prescribed
from the reference motion low-passed at 6 Hz), with the ``Inverse``
tool's options and its ``max_iter`` of 2000 cut to
``WALKER_INVERSE_MAX_ITER``:

27. the inverse, B = ``WALKER_INVERSE_B``: lane 0 the bounds-midpoint
    guess, the others ``batch_guesses``'s jitter (seed 0),
    ``kkt="auto"`` (n + m above 1200: every factor and solve through K1),
    with n, m, K1's shape and launches, every lane's iterations and final
    KKT error, seconds per iteration, the card's peak memory, and lane
    0's share of each leg joint's and pelvis coordinate's net torque
    that its reserve or residual carries; lane 0 converges. Then K1
    against its plain version on this lane's first Newton blocks;
28. card against CPU for lanes 0-1 of phase 27 as in phase 14, with 2
    steps;
29. the inverse's model (the wrapping walker with the GRFs) on the card
    against the CPU, within 1e-10: path lengths, rates and moment arms,
    ``applied_generalized_forces``, ``applied_body_wrenches`` and
    ``joint_reaction`` at 8 seeded poses and at lane 0's iterate of
    phase 27; and a ``JointReactionGoal`` on the right knee added to the
    walker's ``Track`` study at mesh 10: f, its gradient, the J blocks
    and the exact Lagrangian's H blocks at two points with random
    multipliers.

The ``Study``'s guesses, solution files, diagnostics and chunked solves
(``Study.create_guess``, ``create_guess_from_file``,
``objective_breakdown``, ``print_constraint_values``, ``analyze``, and
``solve``'s ``checkpoint_interval``, ``checkpoint_path`` and
``interrupt_file`` through ``make_chunked_solver``):

30. Kirk's problem (phase 12's, mesh 50, tol 1e-7, ``kkt="structured"``)
    through ``Study.solve`` (B=1): checkpointed every 5 iterations it
    converges to the analytic states (1e-5) and writes its .sto; a warm
    start from that file (``create_guess_from_file``) converges in at
    most 2 more iterations to the objective within 1e-6; with the
    interrupt file gone and chunks of 3 the solve stops by iteration 6
    (the JAX package's ``tests/test_checkpointing.py``); K1 against its
    plain version on its first Newton blocks. Then the bench lane
    (phases 2-9's problem): ``create_guess`` of each kind on the card
    against the CPU (bounds and random equal, time-stepping within 1e-9,
    finite, inside the bounds), and at phase 7's lane 0 (without phase
    7, the first jittered start) ``objective_breakdown``, the constraint
    report (relative to at least 1: a violation near a solution is a
    cancellation of larger terms) and ``analyze`` (the forward dynamics'
    acceleration and the muscle's path length and rate) within 1e-10;
31. the walker's ``Track`` study (phase 22's, mesh 50) through
    ``Study.solve`` from ``make_guess``, B=1, phase 22's options with
    ``max_iter`` ``WALKER_STUDY_MAX_ITER``: checkpointed every 5
    iterations against one plain solve (the same iterations and KKT
    error, z within 1e-12), the checkpoint read back by
    ``sto_to_trajectory`` to the returned solution (1e-14); phase 22's
    lane 0 (without phase 22, this phase's solution) written by
    ``trajectory_to_sto`` and taken back by ``create_guess_from_file``
    (states, controls, multipliers and derivatives within 1e-12), and a
    warm solve from it (iterations, KKT error, seconds per iteration,
    reported); at that iterate the diagnostics on the card against the
    CPU within 1e-10 (the report relative to at least 1, as in phase 30;
    outputs: a muscle's activation and the right
    foot's contact force as ``ContactTrackingGoal`` sums it), the
    breakdown summing to ``objective_fn`` there within 1e-10; the
    time-stepping guess on the card, finite, and within 1e-8 of the CPU's
    rollout over the first 10 grid intervals, with both times; K1 against
    its plain version on the lane's first Newton blocks (B=1).

The line before the last lists each kernel with its launches on the main
path, its error against the plain version, and its times beside its
bound, at shape (a), and under a key that names shape (b) the same times
at shape (b), which the main path does not launch; the solve also under
a key for its 1-column times at shape (a); and under a key per shape the
same numbers for the Newton blocks of phases 10 and 13, with the
launches of that phase's solve (phases 10, 13, 15, 16, 17, 19, 20, 22,
27, 30 and 31; the ``Track`` lanes' keys start with ``track_``, the
walker's with ``walker_track_``, its inverse's with ``walker_inverse_``,
phase 30's with ``study_kirk_`` and phase 31's with ``walker_study_``,
each with the launches of the phase's checkpointed solve). The line
before it
gives each phase's wall seconds. The last line of standard output is the result object.
Run from the root of the repository::

    python3 chip_smoke.py [--out results.json] [--phases 8,10]

``--phases 8`` builds K1 and runs only its checks (about a minute): the
loop to iterate on the kernel with; ``--phases 15,16`` runs the inverse
problems, ``--phases 17,18`` the contact leg, ``--phases 19,20,21``
the ``Track`` tool, ``--phases 22,23`` the walker and
``--phases 22,24,25,26`` its prediction, ``--phases 27,28,29`` its
inverse and ``--phases 30,31`` the ``Study``'s conveniences (phase 31
round-trips phase 22's solution when it runs: ``--phases 22,31``).
"""

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

FP64_FLOPS = 67e12  # H100 SXM, FP64 tensor core, NVIDIA data sheet
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
ITERATE_RTOL = 1e-6
KERNEL_RTOL = 1e-10
# above this KKT dimension (phase 16's 6,300 rows; phase 8b's are 3,204),
# the condition number of lane 0 alone and a tenth of the timing
# repetitions: there a library LU takes over a second a call, and an SVD
# of every lane minutes
LARGE_KKT_DIM = 4000
# above this one (the walker's 13,938 rows, phase 22) no condition number
# is taken: an SVD of that size takes minutes
HUGE_KKT_DIM = 10000
# the walker's Track lane (phase 22): its batch and iteration cap (lane 0
# converges in 90 iterations, on the CPU as on the card; the jittered
# lanes hold the batch to the cap, which leaves room for phases 27-29)
WALKER_B = 4
WALKER_MAX_ITER = 92
# the walker's prediction (phase 24): the JAX package's max_iter of 1000
# cut (its convergence is reported, not held)
WALKER_PREDICT_MAX_ITER = 5
# the walker's inverse (phase 27): its batch and the Inverse tool's
# max_iter of 2000 cut (its 8 lanes converge in 30-33 iterations)
WALKER_INVERSE_B = 8
WALKER_INVERSE_MAX_ITER = 50
# phase 29: the wrapping walker's quantities, card against CPU
MODEL_RTOL = 1e-10
# phase 31: the walker's Track study through Study.solve, each solve's
# iteration cap (the chunked and the plain solve are compared iterate for
# iterate, the warm start's convergence is reported)
WALKER_STUDY_MAX_ITER = 10
COUNTERS = ("mu", "it", "converged", "filter_count", "acceptable_count",
            "rescue_count", "stall_count", "mu_wait")


def _fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def _batch_stats(res, tol, dt):
    conv = res.converged.cpu().numpy()
    strict = conv & (res.kkt_error.cpu().numpy() <= tol)
    it = res.iterations.cpu().numpy()
    B = len(conv)
    return {"batch": B, "converged": int(conv.sum()),
            "strict": int(strict.sum()),
            "mean_iterations": float(it.mean()),
            "max_iterations": int(it.max()),
            "wall_s": dt, "solves_per_s": B / dt}


def _solve_lane(torch, tr, opts, z0, Z0, dev, launches=None):
    """Warm up on two lanes for two iterations, then time the batch. With
    ``launches`` (the kernels' count dict), the counts are set to 0 just
    before the timed batch and read just after it."""
    from opensim_moco_tpu_torch.parallel import make_batched_solver

    warm = make_batched_solver(tr, dataclasses.replace(opts, max_iter=2),
                               dev, scale_z0=z0)
    warm(Z0[:2])
    solve = make_batched_solver(tr, opts, dev, scale_z0=z0)
    torch.cuda.synchronize()
    if launches is not None:
        for name in launches:
            launches[name] = 0
    t0 = time.perf_counter()
    res = solve(Z0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    stats = _batch_stats(res, opts.tol, dt)
    if launches is not None:
        stats["launches"] = dict(launches)
    for name, v in res._asdict().items():
        if v.device.type != "cuda":
            _fail(f"result field {name} is on {v.device}, not cuda")
    if not np.isfinite(res.z.cpu().numpy()).all():
        _fail("non-finite solution on the card")
    return res, stats


def _lane_rel_err(a, b):
    """max over lanes of max|a - b| / max|b| (lane by lane)."""
    a = a.cpu().numpy().reshape(len(a), -1)
    b = b.cpu().numpy().reshape(len(b), -1)
    if b.shape[-1] == 0:
        return 0.0
    scale = np.maximum(np.abs(b).max(-1), 1e-300)
    return float((np.abs(a - b).max(-1) / scale).max())


def _iterate_parity(torch, tr, opts, z0, Z0, exact=("mu", "it"),
                    stepwise=False, steps=3):
    """init_fn + ``steps`` body_fn steps on the card and on the CPU, each
    device from its own carry: the largest per-lane relative differences
    after the last step, and whether the fields in ``exact`` are equal. With
    ``stepwise`` also the largest difference over the steps when the CPU
    takes each step from the card's carry, so that each step is compared
    alone (``"stepwise_max_lane_rel_err"``)."""
    from opensim_moco_tpu_torch.config import full_precision
    from opensim_moco_tpu_torch.solver.ipm import Carry, make_kernel

    kern = {name: make_kernel(tr.make_nlp(name), opts, scale_z0=z0,
                              device=name)[:2] for name in ("cuda", "cpu")}

    def errs(card, cpu):
        return {k: _lane_rel_err(getattr(card, k), getattr(cpu, k))
                for k in ("z", "nu", "wL", "wU")}

    carries = {}
    for name, (init_fn, body_fn) in kern.items():
        with full_precision(name):
            c = init_fn(Z0)
            trail = [c]
            for _ in range(steps):
                c = body_fn(c)
                trail.append(c)
        carries[name] = trail
    card, cpu = carries["cuda"], carries["cpu"]
    same = {k: bool(torch.equal(getattr(card[-1], k).cpu(),
                                getattr(cpu[-1], k)))
            for k in exact}
    out = {"max_lane_rel_err": errs(card[-1], cpu[-1]), "exact": same}
    if stepwise:
        worst = errs(card[0], cpu[0])
        for prev, nxt in zip(card[:-1], card[1:]):
            step = kern["cpu"][1](Carry(*[t.cpu() for t in prev]))
            worst = {k: max(v, e) for (k, v), e in
                     zip(worst.items(), errs(nxt, step).values())}
        out["stepwise_max_lane_rel_err"] = worst
    return out


def _events_ms(torch, fn, reps):
    """Mean device ms of ``fn()`` over ``reps`` calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _btb_work(Bt, N, nb, k, r):
    """(factor flops, factor bytes, solve flops, solve bytes) that one
    factor and one r-column solve need at these shapes (f64 values, int32
    pivots; each input read once, each output written once)."""
    blk = N * nb * nb
    f_flops = Bt * (N * (2 / 3 + 2 + 2) * nb ** 3 + 8 * N * nb * nb * k +
                    2 * N * nb * k * k + 2 / 3 * k ** 3)
    f_bytes = Bt * (8 * (2 * blk - nb * nb + 2 * N * nb * k + 2 * k * k) +
                    4 * (N * nb + k))
    s_flops = Bt * (8 * N * nb * nb * r + 4 * N * nb * k * r +
                    2 * k * k * r)
    s_bytes = Bt * (8 * (2 * blk - nb * nb + 2 * N * nb * k + k * k +
                         2 * (N * nb + k) * r) + 4 * (N * nb + k))
    return f_flops, f_bytes, s_flops, s_bytes


def _gemm_barriers(m, n, kk):
    """Barriers of one gemm() call in csrc/btb.cu: one per (64 x 64 output
    tile, 16-deep k-slice), then one."""
    return -(-m // 64) * -(-n // 64) * -(-kk // 16) + 1


def _lu_solve_barriers(n, w, stage_t, stage_x):
    """Barriers of lu_solve(): the pivot copy and the swaps, then for each
    32-row block of both sweeps its triangle (with its staging) and the
    product with the rows beyond it."""
    tri = 1 + (stage_t or stage_x) + stage_x
    count = 2
    for j0 in range(0, n, 32):
        jw = min(32, n - j0)
        count += tri + (_gemm_barriers(n - j0 - jw, w, jw)
                        if j0 + jw < n else 0)
        count += tri + (_gemm_barriers(j0, w, jw) if j0 > 0 else 0)
    return count


def _lu_factor_barriers(n, stage):
    """Barriers of lu_factor(): per 32-column panel the panel (one barrier
    when one warp factors it, up to 64 rows; one per column more when the
    whole block does), its staging (two), the swaps, the block row's
    triangle (with its staging) and the trailing product."""
    count = 0
    for p0 in range(0, n, 32):
        pw, m = min(32, n - p0), n - p0
        count += (1 if m <= 64 else 1 + pw) + 2 * stage + 1
        if pw < m:
            count += 1 + 2 * stage + _gemm_barriers(m - pw, m - pw, pw)
    return count


def _factor_barriers(N, nb, k, smem):
    """Barrier phases (__syncthreads) that one lane of the factor kernel
    passes at these shapes, as reckoned by hand from csrc/btb.cu's control
    flow: the Schur recursion (transpose, the solve with S_{i-1}, the
    product, the LU), the back sweep of T^{-1} B and the border's LU.
    Nothing checks it against the kernel: an edit there must be copied
    here."""
    dev = not smem
    w = nb + k
    count = 0
    for i in range(N):
        if i == 0:
            count += 1
        else:
            count += (2 * (-(-nb // 32)) ** 2 if dev else 0) + 1
            count += _lu_solve_barriers(nb, w, dev, dev)
            count += _gemm_barriers(nb, w, nb)
        count += _lu_factor_barriers(nb, dev) + smem
    if k == 0:
        return count
    count += N * (2 + _lu_solve_barriers(nb, k, True, False))
    return count + 1 + _lu_factor_barriers(k, False)


def _solve_barriers(N, nb, k, r, narrow):
    """Barrier phases (__syncthreads) that one lane of the solve passes
    with r right-hand sides, as reckoned by hand from csrc/btb.cu's control
    flow. Narrow kernel: per step the staging of S_i (and L, and the next
    right-hand sides), the one-warp solve with S_i, the product with L
    (forward, and back but at i = N - 1); the store of x_0; the border's
    staging and solve. Wide kernel: per forward step the solve with
    S_{i-1} and the product with L_{i-1}; per back step the product with
    L_i (not at i = N - 1), the solve with S_i (its triangles staged) and
    the store of x_i; the border's solve.
    Nothing checks it against the kernel: an edit there must be copied
    here."""
    if narrow:
        return 3 * (N - 1) + 2 * N + (N - 1) + 1 + (2 if k else 0)
    count = (N - 1) * (_lu_solve_barriers(nb, r, True, False) +
                       _gemm_barriers(nb, r, nb))
    count += N * (_lu_solve_barriers(nb, r, True, False) + 1)
    count += (N - 1) * _gemm_barriers(r, nb, nb)
    return count + (_lu_solve_barriers(k, r, False, False) if k else 0)


def _bound(flops, nbytes):
    t_ops, t_bytes = flops / FP64_FLOPS, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes
                                        else "bytes")


def _check_solve(torch, fk, fp, K, lu, r, seed, reps):
    """One K1 solve with r right-hand sides (r = 1: the main path's form,
    rhs_T (B, N, nb)) against the plain version, from the factors fk
    (kernel) and fp (plain); K is the lanes' dense KKT matrix and lu its
    library LU. Errors (kernel against plain, the KKT residuals and the
    library solve), times, bound and barrier phases."""
    from opensim_moco_tpu_torch.ops import btb as k1
    from opensim_moco_tpu_torch.solver import structured as plain

    Bt, N, nb, _ = fk.S_lu.shape
    k = fk.B.shape[-1]
    cols = () if r == 1 else (r,)
    rng = np.random.default_rng(seed)
    dev = fk.S_lu.device
    rhs_T = torch.as_tensor(rng.standard_normal((Bt, N, nb) + cols),
                            device=dev)
    rhs_C = torch.as_tensor(rng.standard_normal((Bt, k) + cols), device=dev)
    xk, wk = k1.btb_solve(fk, rhs_T, rhs_C)
    xp, wp = plain.btb_solve(fp, rhs_T, rhs_C)
    torch.cuda.synchronize()
    sol_k = torch.cat([xk.reshape(Bt, -1, r), wk.reshape(Bt, -1, r)], 1)
    sol_p = torch.cat([xp.reshape(Bt, -1, r), wp.reshape(Bt, -1, r)], 1)
    rhs = torch.cat([rhs_T.reshape(Bt, -1, r), rhs_C.reshape(Bt, -1, r)], 1)

    def backward_err(sol):
        res = (K @ sol - rhs).abs().amax((1, 2))
        scale = K.abs().amax((1, 2)) * sol.abs().amax((1, 2))
        return float((res / torch.clamp(scale, min=1.0)).max())

    sol_l = torch.linalg.lu_solve(lu[0], lu[1], rhs)
    out = {"r": r, "max_abs_err": float((sol_k - sol_p).abs().max()),
           "max_lane_rel_err": _lane_rel_err(sol_k, sol_p),
           "plain_vs_library_lane_rel_err": _lane_rel_err(sol_p, sol_l),
           "backward_err_kernel": backward_err(sol_k),
           "backward_err_plain": backward_err(sol_p),
           "finite": bool(torch.isfinite(sol_k).all()),
           "narrow": k1.narrow_solve(nb, k, r),
           "solve_barrier_phases": _solve_barriers(
               N, nb, k, r, k1.narrow_solve(nb, k, r))}
    out["solve_ms"] = _events_ms(
        torch, lambda: k1.btb_solve(fk, rhs_T, rhs_C), reps)
    out["plain_solve_ms"] = _events_ms(
        torch, lambda: plain.btb_solve(fp, rhs_T, rhs_C), max(1, reps // 10))
    out["library_solve_ms"] = _events_ms(
        torch, lambda: torch.linalg.lu_solve(lu[0], lu[1], rhs),
        max(1, reps // 10))
    _, _, s_flops, s_bytes = _btb_work(Bt, N, nb, k, r)
    out["solve_bound_ms"], out["solve_bound_by"] = _bound(s_flops, s_bytes)
    return out


def _check_btb(torch, D, L, Bm, C, rs, seed, reps):
    """K1 against the plain version on one set of blocks: the factor, then
    a solve with each number of right-hand sides in ``rs``; errors, KKT
    residuals and times. The first solve's results sit beside the
    factor's, the others under ``solve_r<r>``. Above ``HUGE_KKT_DIM``
    rows no condition number is taken."""
    from opensim_moco_tpu_torch.ops import btb as k1
    from opensim_moco_tpu_torch.solver import structured as plain

    Bt, N, nb, _ = D.shape
    k = Bm.shape[-1]
    fk = k1.btb_factor(D, L, Bm, C)
    fp = plain.btb_factor(D, L, Bm, C)
    K = plain.dense_kkt(D, L, Bm, C)
    lu = torch.linalg.lu_factor_ex(K)
    torch.cuda.synchronize()
    out = {"shape": {"B": Bt, "N": N, "nb": nb, "k": k},
           "factor_max_lane_rel_err": _lane_rel_err(fk.S_lu, fp.S_lu)}
    if K.shape[-1] <= LARGE_KKT_DIM:
        out["max_cond_2"] = float(torch.linalg.cond(K).max())
    elif K.shape[-1] <= HUGE_KKT_DIM:
        out["cond_2_lane0"] = float(torch.linalg.cond(K[0]))
    for r in rs:
        res = _check_solve(torch, fk, fp, K, lu, r, seed, reps)
        if r == rs[0]:
            out.update(res)
        else:
            out[f"solve_r{r}"] = res
    out["factor_ms"] = _events_ms(
        torch, lambda: k1.btb_factor(D, L, Bm, C), reps)
    out["plain_factor_ms"] = _events_ms(
        torch, lambda: plain.btb_factor(D, L, Bm, C), max(1, reps // 10))
    out["library_factor_ms"] = _events_ms(
        torch, lambda: torch.linalg.lu_factor_ex(K), max(1, reps // 10))
    f_flops, f_bytes, _, _ = _btb_work(Bt, N, nb, k, 1)
    out["factor_barrier_phases"] = _factor_barriers(
        N, nb, k, k1.use_shared_memory(nb, k))
    out["factor_bound_ms"], out["factor_bound_by"] = _bound(f_flops, f_bytes)
    return out


def _kernel_times(r, part):
    """The times of one K1 kernel ("factor" or "solve") in a _check_btb
    result, under the kernels line's keys."""
    return {"ms": r[f"{part}_ms"], "plain_ms": r[f"plain_{part}_ms"],
            "bound_ms": r[f"{part}_bound_ms"],
            "bound_by": r[f"{part}_bound_by"],
            "library_ms": r[f"library_{part}_ms"]}


def _capture_first_newton_blocks(torch, tr, opts, z0, Z0):
    """(D, L, B, C) of the first Newton-step factor of a structured solve
    at the starting points, and each lane's KKT error there (the error
    the first step measures before it moves): one init_fn and one
    body_fn, with K1's factor wrapped to record its arguments."""
    from opensim_moco_tpu_torch.config import full_precision
    from opensim_moco_tpu_torch.ops import btb as k1
    from opensim_moco_tpu_torch.solver.ipm import make_kernel

    seen = []
    real = k1.btb_factor

    def record(*blocks):
        seen.append([b.clone() for b in blocks])
        return real(*blocks)

    k1.btb_factor = record
    try:
        init_fn, body_fn, _, _ = make_kernel(
            tr.make_nlp("cuda"), opts, scale_z0=z0, device="cuda")
        with full_precision("cuda"):
            carry = body_fn(init_fn(Z0))
    finally:
        k1.btb_factor = real
    # seen[0] is the least-squares multiplier start
    return seen[1], carry.kkt.cpu().tolist()


def _random_blocks(torch, Bt, N, nb, k, seed):
    """Well-conditioned random blocks: diagonally dominant D and C."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, device="cuda")

    D = rng.standard_normal((Bt, N, nb, nb))
    D = D + np.swapaxes(D, -1, -2) + 4 * nb * np.eye(nb)
    L = 0.5 * rng.standard_normal((Bt, N - 1, nb, nb))
    Bm = 0.5 * rng.standard_normal((Bt, N, nb, k))
    C = rng.standard_normal((Bt, k, k)) + 4 * N * nb * np.eye(k)
    return t(D), t(L), t(Bm), t(C)


def _padding_cost(torch, Bt, N, nbs, k, reps):
    """K1's factor and 1-column solve times on random blocks of each width
    in ``nbs`` at (Bt, N, k): what padding every block to the widest one
    costs."""
    from opensim_moco_tpu_torch.ops import btb as k1

    out = {}
    for nb in nbs:
        D, L, Bm, C = _random_blocks(torch, Bt, N, nb, k, 4)
        fk = k1.btb_factor(D, L, Bm, C)
        rhs_T = torch.ones(Bt, N, nb, dtype=D.dtype, device=D.device)
        rhs_C = torch.ones(Bt, k, dtype=D.dtype, device=D.device)
        out[f"nb{nb}"] = {
            "factor_ms": _events_ms(
                torch, lambda: k1.btb_factor(D, L, Bm, C), reps),
            "solve_ms": _events_ms(
                torch, lambda: k1.btb_solve(fk, rhs_T, rhs_C), reps)}
    return out


SWEEP_RS = (1, 2, 9)


def _sweep(torch):
    """K1 against the plain version at every shape of EDGE_SHAPES, B=2, one
    factor and a solve with each number of right-hand sides of SWEEP_RS (1
    in the main path's form): the worst per-lane relative error and the
    (N, nb, k, r) that disagree or are not finite."""
    from opensim_moco_tpu_torch.ops import btb as k1
    from opensim_moco_tpu_torch.solver import structured as plain

    worst, bad = 0.0, []
    for N, nb, k in k1.EDGE_SHAPES:
        blocks = _random_blocks(torch, 2, N, nb, k, nb + 7 * N + k)
        fk, fp = k1.btb_factor(*blocks), plain.btb_factor(*blocks)
        for r in SWEEP_RS:
            cols = () if r == 1 else (r,)
            rng = np.random.default_rng(nb)
            rhs_T = torch.as_tensor(rng.standard_normal((2, N, nb) + cols),
                                    device="cuda")
            rhs_C = torch.as_tensor(rng.standard_normal((2, k) + cols),
                                    device="cuda")
            xk, wk = k1.btb_solve(fk, rhs_T, rhs_C)
            xp, wp = plain.btb_solve(fp, rhs_T, rhs_C)
            sk = torch.cat([xk.reshape(2, -1), wk.reshape(2, -1)], 1)
            sp = torch.cat([xp.reshape(2, -1), wp.reshape(2, -1)], 1)
            err = _lane_rel_err(sk, sp)
            worst = max(worst, err)
            if not bool(torch.isfinite(sk).all()) or err > KERNEL_RTOL \
                    or xk.shape != rhs_T.shape:
                bad.append([N, nb, k, r, err])
    return {"shapes": len(k1.EDGE_SHAPES), "rs": list(SWEEP_RS),
            "max_lane_rel_err": worst, "disagree": bad}


def kirk_expected(time):
    """Kirk 1998 eq. 5.1-69/70, the analytic states of the minimum-effort
    problem (a copy of the JAX package's test helper)."""
    e = np.exp
    A = np.array([
        [-2 - 0.5 * e(-2) + 0.5 * e(2), 1 - 0.5 * e(-2) - 0.5 * e(2)],
        [-1 + 0.5 * e(-2) + 0.5 * e(2), 0.5 * e(-2) - 0.5 * e(2)],
    ])
    c2, c3 = np.linalg.solve(A, np.array([5.0, 2.0]))
    x0 = c2 * (-time - 0.5 * e(-time) + 0.5 * e(time)) + \
        c3 * (1 - 0.5 * e(-time) - 0.5 * e(time))
    x1 = c2 * (-1 + 0.5 * e(-time) + 0.5 * e(time)) + \
        c3 * (0.5 * e(-time) - 0.5 * e(time))
    return np.stack([x0, x1], axis=1)


def _kkt_shape(tr):
    """n, m and K1's block shape (N, nb, k) of a transcription's NLP once
    the solver has eliminated its fixed variables, and ``nb_inner``, the
    widest block but the last (every block is padded to ``nb``)."""
    from opensim_moco_tpu_torch.solver.kkt import CompiledStructure

    nlp = tr.make_nlp("cpu")
    st = nlp.structure
    cs = CompiledStructure(st.var_blocks, st.con_blocks, st.border_vars,
                           st.border_cons, nlp.n, nlp.m)
    free = np.nonzero(~(np.isfinite(nlp.lb) & (nlp.lb == nlp.ub)))[0]
    cs = cs.remap_free(free)
    widths = cs.Vm.sum(1) + cs.Cm.sum(1)
    return {"n": nlp.n, "m": nlp.m, "N": cs.N, "nb": cs.nv + cs.nc,
            "nb_inner": int(widths[:-1].max()), "k": len(cs.bv) + len(cs.bc)}


def _lane_iterates(res, tr):
    """Per converged lane: (time, states, controls, parameters) as
    numpy."""
    out = []
    z = res.z.cpu().numpy()
    for b in np.nonzero(res.converged.cpu().numpy())[0]:
        t0, tf, Y, X, _, _, _, _, _, theta = tr.unpack(z[b])
        out.append((t0 + (tf - t0) * np.asarray(tr.taus), Y, X, theta))
    return out


def _factor_spread(torch, D, L, Bm, C):
    """How far the plain factor moves when its inputs are rounded another
    way: the largest per-lane relative change of the Schur blocks' LU when
    every input entry is scaled by 1 +- 2^-52 (random signs), over 8
    draws (seeds 0-7). Where two pivot candidates of a block nearly tie,
    some roundings swap them and others do not, so one draw can miss the
    swap (the walker's first Newton blocks, PERF.md)."""
    from opensim_moco_tpu_torch.solver import structured as plain

    def nudge(a, gen):
        sign = torch.randint(0, 2, a.shape, generator=gen,
                             device=a.device).to(a.dtype) * 2 - 1
        return a * (1 + sign * 2.0 ** -52)

    ref = plain.btb_factor(D, L, Bm, C).S_lu
    worst = 0.0
    for seed in range(8):
        gen = torch.Generator(device=D.device).manual_seed(seed)
        moved = plain.btb_factor(*[nudge(a, gen) for a in (D, L, Bm, C)])
        worst = max(worst, _lane_rel_err(moved.S_lu, ref))
    return worst


def _newton_k1(torch, label, tr, opts, Z0, launches, z0=None):
    """K1 against its plain version on a lane's first Newton blocks, in
    the form of phase 8a: the factor, then a 1-column solve. The factors
    and the solutions agree per lane to 1e-10, or, where the blocks are
    too ill-conditioned for that, to ten times the plain version's own
    spread: for the solutions, against the library LU solve of the same
    system; for the factors, against the plain factor of inputs rounded
    another way (``_factor_spread``); and K1's backward error is at most
    ten times the plain version's. (Two backward-stable solves of one
    system differ by up to its condition number times their backward
    error: the swing-up's first Newton system has backward errors near
    1.7e-10 in both and solutions that differ by 3e-8, K1 from the plain
    version as the plain version from the library.) The kernels line
    takes the result under a key naming its shape, with ``launches``
    (that lane's solve's counts) and ``kkt_start`` (each lane's KKT error
    at its start). The NLP is scaled at ``z0`` (default:
    the bounds-midpoint guess), as the lane's solve scales it."""
    blocks, kkt_start = _capture_first_newton_blocks(
        torch, tr, opts, tr.initial_guess() if z0 is None else z0, Z0)
    D, _, _, C = blocks
    big = D.shape[1] * D.shape[2] + C.shape[-1] > LARGE_KKT_DIM
    res = _check_btb(torch, *blocks, (1,), 1, 10 if big else 200)
    res["plain_factor_spread"] = _factor_spread(torch, *blocks)
    sh = res["shape"]
    key = f"B{sh['B']}_N{sh['N']}_nb{sh['nb']}_k{sh['k']}"
    res["launches"] = dict(launches)
    res["kkt_start"] = kkt_start
    print(f"{label} K1 vs plain, Newton blocks {key}: " + json.dumps(res),
          flush=True)
    spread = max(KERNEL_RTOL, 10 * res["plain_vs_library_lane_rel_err"])
    f_spread = max(spread, 10 * res["plain_factor_spread"])
    if not res["finite"] or res["factor_max_lane_rel_err"] > f_spread \
            or res["max_lane_rel_err"] > spread or \
            res["backward_err_kernel"] > 10 * res["backward_err_plain"] + \
            1e-14:
        _fail(f"{label}: K1 and the plain version disagree at {key}")
    return key, res


def _inverse_options(study, kkt):
    """The ``Inverse`` tool's IPM options (its ``study``'s), with
    ``max_iter`` 300 in place of 2000 and the given ``kkt``."""
    return dataclasses.replace(study.ipm_options, max_iter=300, kkt=kkt)


def _arm_inverse(mesh_interval):
    """The six-muscle arm's ``Inverse`` (``tests/inverse_arm.py``) with the
    port's classes."""
    from opensim_moco_tpu_torch.models import MechModelBuilder, muscle
    from opensim_moco_tpu_torch.models.model import Model
    from opensim_moco_tpu_torch.tools import Inverse

    inverse_arm = _tests_module("inverse_arm")
    return Inverse(model=inverse_arm.build_arm(MechModelBuilder, Model,
                                               muscle),
                   kinematics=inverse_arm.kinematics(),
                   mesh_interval=mesh_interval,
                   reserves_weight=inverse_arm.RESERVES_WEIGHT)


def _track_starts(tr, guess, B):
    """B starts of a ``Track`` lane: lane 0 the tool's guess as it is, the
    others that guess plus the jitter of ``batch_guesses(tr, B,
    scale=0.05, seed=0)`` (its difference from the bounds-midpoint guess),
    clipped to the bounds."""
    from opensim_moco_tpu_torch.parallel import batch_guesses

    lb, ub = tr.bounds()
    Z = np.clip(guess + (batch_guesses(tr, B, scale=0.05, seed=0)
                         - tr.initial_guess()), lb, ub)
    Z[0] = guess
    return Z


def _rms_tracking_err(res, tr, reference):
    """The largest, over the converged lanes, RMS over the grid and the
    coordinates of their distance from the tracked reference (a
    ``StateTrackingGoal``'s ``reference``)."""
    names = [n for n in reference if n.endswith("/value")]
    cols = [tr.rep.state_names.index(n) for n in names]
    errs = [np.sqrt(np.mean([(Y[:, c] - np.interp(ts, *reference[n])) ** 2
                             for c, n in zip(cols, names)]))
            for ts, Y, _, _ in _lane_iterates(res, tr)]
    return float(max(errs)) if errs else None


def _point_mass_track():
    """``tests/test_track.py``'s ``Track`` (a 1 kg slider driven by
    sin(2 pi t), its motion tracked at weight 10), the reference times
    and the analytic coordinate."""
    from opensim_moco_tpu_torch.models import MechModelBuilder
    from opensim_moco_tpu_torch.models.model import Model
    from opensim_moco_tpu_torch.tools import Track

    b = MechModelBuilder(gravity=(0.0, 0.0, 0.0))
    b.add_body("b", mass=1.0, joint_name="j", kind="prismatic",
               axis=(1, 0, 0), coord_name="q")
    model = Model(b.finalize())
    model.add_coordinate_actuator("act", "q", optimal_force=1.0,
                                  min_control=-10, max_control=10)
    model.finalize()
    w = 2 * np.pi
    times = np.linspace(0, 1.0, 101)
    q = times / w - np.sin(w * times) / w ** 2
    u = (1 - np.cos(w * times)) / w
    return Track(model=model,
                 states_reference=(times, {"/jointset/j/q/value": q,
                                           "/jointset/j/q/speed": u}),
                 states_global_weight=10.0, control_effort_weight=0.0001,
                 mesh_interval=0.025, convergence_tolerance=1e-5), times, q


def _tests_module(name):
    """A JAX-free helper module of ``tests/`` (the in-code models the CPU
    tests share with this script)."""
    import importlib

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
    if path not in sys.path:
        sys.path.insert(0, path)
    return importlib.import_module(name)


def _expand_lane(study, tr, res, lane):
    """Lane ``lane`` of a batched result as the ``Solution`` that
    ``Study.solve`` makes of its one lane."""
    return study.expand(tr, *(a[lane].cpu().numpy() for a in (
        res.z, res.f, res.kkt_error, res.iterations, res.converged)))


def _prediction_report(torch, tr, sol):
    """The walker prediction's outcome: iterations, final KKT error,
    convergence, objective, final time, the center of mass's average
    forward speed (its x displacement over the duration, as the JAX
    package's test reckons it), the largest residual of the half-cycle
    symmetry rows, and whether the iterate is finite."""
    rep = tr.rep
    m = rep.model
    p = m.default_params("cpu")
    Y = torch.as_tensor(sol.states)
    X = torch.as_tensor(sol.controls)
    com = m.mech.mass_center(p["mech"], Y[[0, -1], :m.nq])
    duration = float(sol.time[-1] - sol.time[0])
    ends = [(torch.as_tensor(sol.time[k]), Y[k], X[k]) for k in (0, -1)]
    symmetry = next(g for g in rep.goals if g.name == "symmetry")
    return {"iterations": sol.num_iterations, "kkt_error": sol.kkt_error,
            "converged": sol.success, "objective": sol.objective,
            "final_time": float(sol.time[-1]),
            "com_speed": float(com[1, 0] - com[0, 0]) / duration,
            "max_symmetry_residual": float(
                symmetry.values(rep, *ends, p).abs().max()),
            "finite": bool(np.isfinite(sol.raw_iterate).all() and
                           np.isfinite([sol.objective, sol.kkt_error]).all())}


def _goal_derivatives(torch, tr, dev, Z, NU):
    """f, its gradient, the compressed Jacobian blocks and the exact
    Lagrangian's compressed Hessian blocks at the lanes ``Z`` (numpy) with
    multipliers ``NU``, on ``dev``."""
    from torch.func import grad

    from opensim_moco_tpu_torch.config import full_precision
    from opensim_moco_tpu_torch.solver.kkt import CompiledStructure
    from opensim_moco_tpu_torch.solver.structured import BlockDerivatives

    nlp = tr.make_nlp(dev)
    st = nlp.structure
    cs = CompiledStructure(st.var_blocks, st.con_blocks, st.border_vars,
                           st.border_cons, nlp.n, nlp.m)
    bd = BlockDerivatives(cs, nlp.constraints, dev)
    z = torch.as_tensor(Z, device=dev)
    nu = torch.as_tensor(NU, device=dev)

    def lag_grad(zz, nn):
        return grad(lambda q: (nlp.objective(q) +
                               (nlp.constraints(q) * nn).sum(-1)).sum())(zz)

    with full_precision(dev):
        out = {"f": nlp.objective(z),
               "grad_f": grad(lambda q: nlp.objective(q).sum())(z)}
        out.update(bd.jac_blocks(z))
        out.update(bd.hess_blocks(lag_grad, z, nu))
    return {k: v.cpu() for k, v in out.items()}


def _tracking_goals_parity(torch):
    """The seven tracking and output goals of the CPU goal test
    (``tests/tracking_goals_model.py``: a body on a three-rotation custom
    joint and a forearm, all eight goals as costs at mesh 4) on the card
    against the CPU: f, its gradient, the J blocks and the exact
    Lagrangian's H blocks (the acceleration goal's nested ``jvp``s through
    the forward dynamics under the Hessian pass), at the bounds-midpoint
    guess and a jittered point with random multipliers (seed 0)."""
    from opensim_moco_tpu_torch import ocp
    from opensim_moco_tpu_torch.models import MechModelBuilder
    from opensim_moco_tpu_torch.models.model import Model

    tgm = _tests_module("tracking_goals_model")
    tr = tgm.problem((MechModelBuilder, Model, ocp))
    lb, ub = tr.bounds()
    rng = np.random.default_rng(0)
    z0 = tr.initial_guess()
    width = np.where(np.isfinite(ub - lb), ub - lb, 1.0)
    Z = np.stack([z0, np.clip(z0 + 0.05 * width * rng.uniform(-1, 1, tr.n),
                              lb, ub)])
    m = sum(size for _, size in tr.constraint_group_info())
    NU = rng.standard_normal((2, m))
    card, cpu = (_goal_derivatives(torch, tr, dev, Z, NU)
                 for dev in ("cuda", "cpu"))
    return {"n": tr.n, "m": m, "goals": [g.name for g in tr.rep.goals],
            "max_lane_rel_err": {k: _lane_rel_err(card[k], cpu[k])
                                 for k in cpu}}


def _reserve_share(torch, tr, res):
    """Per reserve and pelvis residual of the walker's inverse, on lane 0
    if it converged: the share of its coordinate's net torque it carries,
    sum |actuator torque| / sum |tau_net| over the grid (tau_net from the
    prescribed kinematics and the GRFs, ``prescribed_point_constants``)."""
    from opensim_moco_tpu_torch.example_models import walker2d

    if not bool(res.converged[0]):
        return None
    m = tr.rep.model
    p = m.default_params("cpu")
    t0, tf, _, X, _, _, _, _, _, _ = tr.unpack(res.z[0].cpu().numpy())
    ts = torch.as_tensor(t0 + (tf - t0) * np.asarray(tr.taus))
    tau = m.prescribed_point_constants(p, ts)["tau_net"].numpy()
    out = {}
    for j, a in enumerate(m.actuators):
        if a.name == walker2d.LUMBAR_ACTUATOR[0]:
            continue
        torque = a.optimal_force * X[:, j]
        out[a.name] = float(np.abs(torque).sum() /
                            max(np.abs(tau[:, a.coord]).sum(), 1e-300))
    return out


def _walker_model_quantities(torch, m, dev, args):
    """The wrapping walker's path lengths, rates, moment arms, applied
    generalized forces (the GRFs among them) and joint reactions at the
    points ``args`` = (t, q, u, z, x) (numpy), on ``dev``."""
    p = m.default_params(dev)
    t, q, u, z, x = (torch.as_tensor(a, device=dev) for a in args)
    lMT, vMT = m.muscle_path_kinematics(p, q, u)
    return {k: v.cpu() for k, v in {
        "lMT": lMT, "vMT": vMT,
        "R": torch.func.vmap(torch.func.jacfwd(
            lambda qq: m.path_lengths(p, qq)))(q),
        "f_app": m.applied_generalized_forces(p, t, q, u, z, x),
        "body_wrenches": m.applied_body_wrenches(p, t, q, u, z, x),
        "joint_reaction": m.joint_reaction(p, t, q, u, z, x)}.items()}


def _walker_model_parity(torch, tr, res):
    """The inverse's model (the wrapping walker with the GRFs) on the card
    against the CPU: at 8 seeded poses near the reference (seed 0: the
    reference at random times of the half cycle plus 0.05 rad of jitter,
    random speeds, states and controls in their bounds) and, with phase
    27's result, at lane 0's iterate (the prescribed q, u at the grid
    times with its states and controls); max over the quantities of
    max |card - CPU| / max |CPU|."""
    from opensim_moco_tpu_torch.example_models import walker2d

    m = tr.rep.model
    rng = np.random.default_rng(0)
    t = rng.uniform(0.0, walker2d.HALF_CYCLE, 8)
    q = np.stack([walker2d.pose(tk) for tk in t]) + \
        0.05 * rng.uniform(-1, 1, (8, m.nq))
    u = rng.standard_normal((8, m.nq))
    lo, hi = m.default_state_bounds()
    z = rng.uniform(np.maximum(lo, 0.05), np.minimum(hi, 1.5), (8, m.naux))
    clo, chi = m.default_control_bounds()
    x = rng.uniform(clo, chi, (8, len(clo)))
    sets = {"seeded": (t, q, u, z, x)}
    if res is not None:
        t0, tf, Y, X, _, _, _, _, _, _ = tr.unpack(res.z[0].cpu().numpy())
        ts = torch.as_tensor(t0 + (tf - t0) * np.asarray(tr.taus))
        qg, ug, _ = m.position_motion(m.default_params("cpu"), ts)
        sets["phase27_lane0"] = (ts.numpy(), qg.numpy(), ug.numpy(), Y, X)
    out = {"points": {k: len(v[0]) for k, v in sets.items()},
           "max_rel_err": {}}
    for name, args in sets.items():
        card, cpu = (_walker_model_quantities(torch, m, dev, args)
                     for dev in ("cuda", "cpu"))
        for k in cpu:
            err = float((card[k] - cpu[k]).abs().max() /
                        cpu[k].abs().max().clamp(min=1e-300))
            out["max_rel_err"][f"{name}_{k}"] = err
    return out


def _joint_reaction_goal_parity(torch, walker2d_track_study):
    """A ``JointReactionGoal`` on the right knee (the reaction on
    ``tibia_r``: force x, y and the moment about z) added to the walker's
    ``Track`` study at mesh 10: f, its gradient, the J blocks and the
    exact Lagrangian's H blocks on the card against the CPU at the tool's
    guess and a jittered point, with random multipliers (seed 0)."""
    from opensim_moco_tpu_torch.ocp import JointReactionGoal

    study, guess = walker2d_track_study(10)
    model = study.problem.model
    knee = [b.name for b in model.mech.bodies].index("tibia_r")
    study.problem.add_goal(JointReactionGoal(
        name="knee_r_reaction", joint=knee, weight=1e-4,
        measures=("force-x", "force-y", "moment-z")))
    tr = study.transcription()
    lb, ub = tr.bounds()
    rng = np.random.default_rng(0)
    width = np.where(np.isfinite(ub - lb), ub - lb, 1.0)
    Z = np.stack([guess, np.clip(guess + 0.01 * width *
                                 rng.uniform(-1, 1, tr.n), lb, ub)])
    m = sum(size for _, size in tr.constraint_group_info())
    NU = rng.standard_normal((2, m))
    card, cpu = (_goal_derivatives(torch, tr, dev, Z, NU)
                 for dev in ("cuda", "cpu"))
    return {"n": tr.n, "m": m,
            "max_lane_rel_err": {k: _lane_rel_err(card[k], cpu[k])
                                 for k in cpu}}


def _rel_dict(card, cpu, floor=1e-300):
    """max |card - cpu| over the keys of two {name: float} dicts, relative
    to the CPU's largest magnitude or ``floor``, the larger (keys must
    agree)."""
    if list(card) != list(cpu):
        _fail(f"the card's keys {list(card)} differ from the CPU's "
              f"{list(cpu)}")
    scale = max([abs(v) for v in cpu.values()] + [floor])
    return max([abs(card[k] - cpu[k]) for k in cpu] + [0.0]) / scale


def _diagnostics_parity(study, sol, outputs):
    """``Study.objective_breakdown``, ``print_constraint_values`` (its
    report, printed quietly) and ``analyze`` of ``outputs`` at ``sol`` on
    the card against the CPU: each one's largest difference relative to
    the CPU's largest magnitude (the report's to at least 1), and the
    card's breakdown and report."""
    import contextlib
    import io

    got = {}
    for dev in ("cuda", "cpu"):
        with contextlib.redirect_stdout(io.StringIO()):
            got[dev] = (study.objective_breakdown(sol, dev),
                        study.print_constraint_values(sol, dev),
                        study.analyze(sol, outputs, dev))
    (bc, cc, ac), (bp, cp, ap) = got["cuda"], got["cpu"]
    if ac.column_names != ap.column_names:
        _fail(f"analyze's columns differ: {ac.column_names}, "
              f"{ap.column_names}")
    return {"breakdown": bc, "constraint_report": cc,
            "analyze_columns": ac.column_names,
            "max_rel_err": {
                "objective_breakdown": _rel_dict(bc, bp),
                # a violation near a solution is a cancellation of terms
                # of order 1 and more, whose rounding is not small next
                # to it: its differences are taken relative to at least 1
                "constraint_report": _rel_dict(cc, cp, floor=1.0),
                "analyze": float(np.abs(ac.data - ap.data).max() /
                                 max(np.abs(ap.data).max(), 1e-300)),
                "analyze_time": float(np.abs(ac.time - ap.time).max())}}


def _guess_parity(torch, study):
    """``create_guess`` of each kind on the card against the CPU: bounds
    and random (seed 3) equal exactly; the time-stepping guess's largest
    difference relative to its magnitude, its seconds on each device,
    whether it is finite and inside the bounds."""
    tr = study.transcription()
    lb, ub = tr.bounds()
    out = {}
    for kind, seed in (("bounds", 0), ("random", 3)):
        out[f"{kind}_equal"] = bool(np.array_equal(
            study.create_guess(kind, seed=seed),
            study.create_guess(kind, seed=seed, device="cpu")))
    zs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        zs[dev] = study.create_guess("time-stepping", device=dev)
        out[f"time_stepping_s_{dev}"] = time.perf_counter() - t0
    z = zs["cuda"]
    out["time_stepping_rel_err"] = float(
        np.abs(z - zs["cpu"]).max() / np.abs(zs["cpu"]).max())
    out["time_stepping_finite"] = bool(np.isfinite(z).all())
    out["time_stepping_in_bounds"] = bool(((z >= lb) & (z <= ub)).all())
    return out


def _study_kirk(torch, tmp, study):
    """Phase 30's checks on Kirk's problem (the JAX package's
    ``tests/test_checkpointing.py``): a solve checkpointed every 5
    iterations converges and writes its file; a warm start from the file
    converges in at most 2 more iterations to the objective within 1e-6;
    with the interrupt file gone and chunks of 3 the solve stops by
    iteration 6. Returns the report and the launches of the checkpointed
    solve."""
    from opensim_moco_tpu_torch.ops.btb import LAUNCHES

    path = os.path.join(tmp, "kirk.sto")
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    t0 = time.perf_counter()
    sol = study.solve(checkpoint_interval=5, checkpoint_path=path)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    out = {"converged": sol.success, "iterations": sol.num_iterations,
           "objective": sol.objective, "wall_s": time.perf_counter() - t0,
           "launches": launches, "file_written": os.path.exists(path),
           "max_state_err": float(np.abs(
               sol.states[:, :2] - kirk_expected(sol.time)).max())}
    t0 = time.perf_counter()
    warm = study.solve(guess=study.create_guess_from_file(path))
    out["warm"] = {"converged": warm.success,
                   "iterations": warm.num_iterations,
                   "objective_diff": abs(warm.objective - sol.objective),
                   "wall_s": time.perf_counter() - t0}
    stop = os.path.join(tmp, "keep_running.txt")  # never made: gone
    long = dataclasses.replace(study.ipm_options, tol=1e-12, max_iter=10000)
    short = study.ipm_options
    study.ipm_options = long
    try:
        cut = study.solve(checkpoint_interval=3, interrupt_file=stop)
    finally:
        study.ipm_options = short
    out["interrupted_iterations"] = cut.num_iterations
    return out, launches


def _walker_study(torch, tmp, study, guess, warm_src=None):
    """Phase 31's checks on the walker's ``Track`` study through
    ``Study.solve`` (B=1, the study's options): the checkpointed and the
    plain solve of ``max_iter`` iterations; the checkpoint read back;
    ``warm_src`` (a ``Solution``; None: the checkpointed solve's) written
    with ``trajectory_to_sto`` and taken back by
    ``create_guess_from_file``, then a warm solve from it; the diagnostics
    at that iterate on the card against the CPU; the time-stepping guess.
    Returns the report and the launches of the checkpointed solve."""
    from opensim_moco_tpu_torch.ops.btb import LAUNCHES
    from opensim_moco_tpu_torch.utils.rollout import rollout
    from opensim_moco_tpu_torch.utils.tables import (sto_to_trajectory,
                                                     trajectory_to_sto)

    tr = study.transcription()
    out = {}
    path = os.path.join(tmp, "walker.sto")
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    t0 = time.perf_counter()
    chunked = study.solve(guess=guess, checkpoint_interval=5,
                          checkpoint_path=path)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    out["chunked"] = {"iterations": chunked.num_iterations,
                      "kkt_error": chunked.kkt_error,
                      "wall_s": time.perf_counter() - t0,
                      "launches": launches}
    t0 = time.perf_counter()
    plain = study.solve(guess=guess)
    torch.cuda.synchronize()
    out["plain"] = {"iterations": plain.num_iterations,
                    "kkt_error": plain.kkt_error,
                    "wall_s": time.perf_counter() - t0}
    out["chunked_vs_plain_z_rel_err"] = float(
        np.abs(chunked.raw_iterate - plain.raw_iterate).max() /
        np.abs(plain.raw_iterate).max())
    back = sto_to_trajectory(path)
    out["checkpoint_rel_err"] = max(
        float(np.abs(getattr(back, k) - getattr(chunked, k)).max() /
              max(np.abs(getattr(chunked, k)).max(), 1e-300))
        if getattr(chunked, k).size else 0.0
        for k in ("states", "controls", "multipliers"))
    # the .sto round trip of a solution, back through a guess file
    if warm_src is None:
        warm_src = chunked
    warm_src.unseal()
    path = os.path.join(tmp, "solution.sto")
    trajectory_to_sto(warm_src, path)
    z = study.create_guess_from_file(path)
    o = tr.offsets
    blocks = [slice(*o[k]) for k in ("states", "controls", "multipliers",
                                     "derivs")]
    ref = warm_src.raw_iterate
    out["round_trip"] = {"max_abs_err": max(
        float(np.abs(z[b] - ref[b]).max()) for b in blocks
        if b.stop > b.start)}
    t0 = time.perf_counter()
    warm = study.solve(guess=z)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    out["warm"] = {"iterations": warm.num_iterations,
                   "kkt_error": warm.kkt_error, "converged": warm.success,
                   "wall_s": dt,
                   "s_per_iteration": dt / max(1, warm.num_iterations)}
    # the diagnostics at the source's iterate
    m = tr.rep.model
    act = tr.rep.state_index(f"/forceset/{m.muscles[0].name}/activation")
    feet = ("contactHeel_r", "contactFront_r")

    def activation(rep, t, y, x, lam, p):
        return y[..., act]

    def right_grf(rep, t, y, x, lam, p):
        forces = rep.model.contact_forces(p, t, y[..., :rep.model.nq],
                                          y[..., rep.model.nq:
                                            2 * rep.model.nq])
        return sum(forces[n] for n in feet)

    diag = _diagnostics_parity(study, warm_src, {
        "activation": activation, "right_grf": right_grf})
    f = float(tr.objective_fn("cpu")(torch.as_tensor(ref)))
    diag["breakdown_sum_rel_err"] = abs(
        sum(diag["breakdown"].values()) - f) / abs(f)
    out["diagnostics"] = diag
    # the time-stepping guess: the whole rollout on the card, the first 10
    # grid intervals of the same rollout on the CPU
    t0 = time.perf_counter()
    zt = study.create_guess("time-stepping")
    out_ts = {"wall_s_cuda": time.perf_counter() - t0,
              "finite": bool(np.isfinite(zt).all())}
    t0v, tfv, Y, X, _, _, _, _, _, _ = tr.unpack(tr.initial_guess())
    ts = t0v + (tfv - t0v) * np.asarray(tr.taus)
    G = min(11, tr.G)
    t0 = time.perf_counter()
    ys = rollout(m, m.default_params("cpu"), ts[:G], X[:G],
                 torch.as_tensor(Y[0])).numpy()
    out_ts["wall_s_cpu_first_intervals"] = time.perf_counter() - t0
    lb, ub = (a[slice(*tr.offsets["states"])].reshape(tr.G, tr.ny)[:G]
              for a in tr.bounds())
    ycpu = np.clip(ys, lb, ub)
    ycard = tr.unpack(zt)[2][:G]
    out_ts["first_intervals_rel_err"] = float(np.abs(ycard - ycpu).max() /
                                              np.abs(ycpu).max())
    out["time_stepping"] = out_ts
    return out, launches


def _check_lanes(name, stats):
    if stats["converged"] == 0:
        _fail(f"{name}: no lane converged")
    if min(stats["launches"].values()) == 0:
        _fail(f"{name}: a kernel of the path never launched: "
              f"{stats['launches']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the phase results to this "
                    "JSON file")
    ap.add_argument("--phases",
                    default="2,3,4,5,6,7,8,9,10,11,12,13,14,15,16,17,18,"
                    "19,20,21,22,23,24,25,26,27,28,29,30,31",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    # ---- phase 1: device, kernel build
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this check needs a CUDA "
              "card and has no CPU fallback")
    from opensim_moco_tpu_torch.examples import (
        contact_leg_study, contact_leg_track_study, coupler_pendulum_study,
        double_pendulum_swingup_study, hanging_muscle_inverse,
        hanging_muscle_study, kirk_min_effort_study, oscillator_mass_study,
        walker2d_inverse_study, walker2d_prediction_study,
        walker2d_track_study)
    from opensim_moco_tpu_torch.ops import _build
    from opensim_moco_tpu_torch.ops.btb import LAUNCHES
    from opensim_moco_tpu_torch.parallel import (batch_guesses,
                                                 make_batched_solver)
    from opensim_moco_tpu_torch.solver.ipm import IPMOptions

    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"phase 1 device: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)
    t0 = time.perf_counter()
    reports = _build.build_all()
    print(f"phase 1 kernels built in {time.perf_counter() - t0:.3f} s: "
          + json.dumps({name: [ln for ln in rep.splitlines()
                               if "registers" in ln or "spill" in ln]
                        for name, rep in reports.items()}), flush=True)
    dev = torch.device("cuda")
    out = {"card": card, "kind": kind, "torch": torch.__version__}
    phase_start = {}

    bench = dict(tol=3e-3, bound_relax=1e-6, mu_init=1e-2, kappa_eps=100.0,
                 acceptable_tol_factor=30.0, acceptable_iter=10,
                 max_rescues=100)
    tr = hanging_muscle_study(25, ignore_tendon_compliance=False,
                              ignore_activation_dynamics=False,
                              tendon_dynamics_implicit=True).transcription()
    # the bench's max_iter of 200 cut to 40 (phases 2-9; 5 at 50, 11 at 30,
    # 17 at 6), so that the whole script stays under 1,200 s: the lanes
    # left at max_iter hold each batch to the end (PERF.md, section 6)
    opts = IPMOptions(max_iter=40, kkt="dense", **bench)
    opts_st = dataclasses.replace(opts, kkt="structured")
    z0 = tr.initial_guess()
    Z0 = batch_guesses(tr, 32, scale=0.05, seed=0)
    res = None

    # ---- phase 2: full-dynamics lane, dense KKT
    if 2 in phases:
        phase_start[2] = time.perf_counter()
        res, stats = _solve_lane(torch, tr, opts, z0, Z0[:8], dev)
        print("phase 2 full dynamics, kkt=dense (mesh 25, B=8, max_iter 40, "
              "f64, cuda): "
              + json.dumps(stats), flush=True)
        out["full_dynamics_dense"] = stats
        if stats["converged"] == 0:
            _fail("phase 2: no lane converged")

    # ---- phase 3: card against CPU, iterate level
    if 3 in phases:
        phase_start[3] = time.perf_counter()
        par = _iterate_parity(torch, tr, opts, z0, Z0)
        print("phase 3 iterate parity cuda vs cpu after 3 steps, kkt=dense: "
              + json.dumps(par), flush=True)
        out["iterate_parity_dense"] = par
        if max(par["max_lane_rel_err"].values()) > ITERATE_RTOL or \
                not all(par["exact"].values()):
            _fail("phase 3: card and CPU iterates disagree")

    # ---- phase 4: card against CPU, solve level (lanes 0-3)
    if 4 in phases and res is not None:
        phase_start[4] = time.perf_counter()
        from opensim_moco_tpu_torch.parallel import make_batched_solver

        t0 = time.perf_counter()
        cpu_res = make_batched_solver(tr, opts, "cpu", scale_z0=z0)(Z0[:4])
        cpu_s = time.perf_counter() - t0
        conv_cpu = cpu_res.converged.numpy()
        conv_gpu = res.converged[:4].cpu().numpy()
        f_cpu = cpu_res.f.numpy()
        f_gpu = res.f[:4].cpu().numpy()
        rel = np.abs(f_gpu - f_cpu) / np.abs(f_cpu)
        lanes = {"converged_cpu": conv_cpu.tolist(),
                 "converged_cuda": conv_gpu.tolist(),
                 "iterations_cpu": cpu_res.iterations.tolist(),
                 "iterations_cuda": res.iterations[:4].tolist(),
                 "f_cpu": f_cpu.tolist(), "f_cuda": f_gpu.tolist(),
                 "cpu_wall_s": cpu_s}
        print("phase 4 solve parity lanes 0-3, kkt=dense: "
              + json.dumps(lanes), flush=True)
        out["solve_parity_dense"] = lanes
        if not conv_cpu.any():
            _fail("phase 4: no lane converged on the CPU")
        if (conv_cpu & ~conv_gpu).any():
            _fail("phase 4: a lane converged on the CPU but not on the card")
        if (rel[conv_cpu] > 1e-2).any():
            _fail(f"phase 4: objectives differ by {rel.max():.3e} (> 1e-2)")

    # ---- phase 5: simplified lane, dense KKT
    if 5 in phases:
        phase_start[5] = time.perf_counter()
        tr_s = hanging_muscle_study(25, ignore_tendon_compliance=True,
                                    ignore_activation_dynamics=True,
                                    tendon_dynamics_implicit=False
                                    ).transcription()
        opts_s = IPMOptions(max_iter=50, kkt="dense", **bench)
        Z0_s = batch_guesses(tr_s, 8, scale=0.05, seed=0)
        _, stats_s = _solve_lane(torch, tr_s, opts_s, tr_s.initial_guess(),
                                 Z0_s, dev)
        print("phase 5 simplified, kkt=dense (mesh 25, B=8, max_iter 50, "
              "f64, cuda): "
              + json.dumps(stats_s), flush=True)
        out["simplified_dense"] = stats_s
        if stats_s["converged"] == 0:
            _fail("phase 5: no lane converged")

    # ---- phase 6: full-dynamics lane, kkt="auto" (the JAX bench's mode)
    launches = {}
    if 6 in phases:
        phase_start[6] = time.perf_counter()
        _, stats6 = _solve_lane(torch, tr, dataclasses.replace(
            opts, kkt="auto"), z0, Z0, dev, LAUNCHES)
        print("phase 6 full dynamics, kkt=auto (mesh 25, B=32, max_iter 40, "
              "f64, cuda): "
              + json.dumps(stats6), flush=True)
        out["full_dynamics_auto"] = stats6
        if stats6["converged"] == 0:
            _fail("phase 6: no lane converged")
        if stats6["launches"]["btb_factor"] == 0 or \
                stats6["launches"]["btb_solve"] == 0:
            _fail("phase 6: the least-squares start did not go through K1")

    # ---- phase 7: full-dynamics lane, kkt="structured" (K1 throughout)
    res7 = None
    if 7 in phases:
        phase_start[7] = time.perf_counter()
        res7, stats7 = _solve_lane(torch, tr, opts_st, z0, Z0, dev,
                                   LAUNCHES)
        launches = stats7["launches"]
        print("phase 7 full dynamics, kkt=structured (mesh 25, B=32, "
              "max_iter 40, f64, cuda): " + json.dumps(stats7), flush=True)
        out["full_dynamics_structured"] = stats7
        if stats7["converged"] == 0:
            _fail("phase 7: no lane converged")
        if min(launches.values()) == 0:
            _fail(f"phase 7: a kernel of the path never launched: "
                  f"{launches}")
        if res is not None:
            B2 = len(res.f)
            both = res.converged.cpu().numpy() & \
                res7.converged[:B2].cpu().numpy()
            f_d, f_s = res.f.cpu().numpy(), res7.f[:B2].cpu().numpy()
            rel = np.abs(f_s - f_d) / np.abs(f_d)
            print(f"phase 7 lanes 0-{B2 - 1} converged under dense and "
                  f"structured: "
                  f"{int(both.sum())}, max objective rel diff "
                  f"{float(rel[both].max()) if both.any() else 0.0}",
                  flush=True)
            if (rel[both] > 1e-2).any():
                _fail("phase 7: dense and structured objectives differ by "
                      "more than 1e-2")

    # ---- phase 8: K1 against its plain version
    kernels = []
    if 8 in phases:
        phase_start[8] = time.perf_counter()
        blocks, _ = _capture_first_newton_blocks(torch, tr, opts_st, z0, Z0)
        shapes = {"a_bench_newton": (blocks, (3, 1), 1, 200),
                  "b_random_nb200": (_random_blocks(torch, 8, 16, 200, 4, 2),
                                     (3,), 3, 20)}
        k1 = {}
        for name, (blk, rs, seed, reps) in shapes.items():
            k1[name] = _check_btb(torch, *blk, rs, seed, reps)
            print(f"phase 8{name[0]} K1 vs plain, {name}: "
                  + json.dumps(k1[name]), flush=True)
        # (c) one singular lane: non-finite output, no exception, in the
        # shared-memory (nb=34) and the device-memory (nb=200) mode
        from opensim_moco_tpu_torch.ops import btb as k1_ops

        sing = {}
        for nb in (34, 200):
            D, L, Bm, C = _random_blocks(torch, 2, 4, nb, 1, 4)
            D[1, 2] = 0.0  # lane 1: D_2 = 0 and L_1 = 0 make S_2 = 0
            L[1, 1] = 0.0
            fac = k1_ops.btb_factor(D, L, Bm, C)
            x, w = k1_ops.btb_solve(fac, torch.ones_like(D[..., 0]),
                                    torch.ones_like(C[..., 0]))
            torch.cuda.synchronize()
            sing[f"nb{nb}"] = {
                "shared_memory": k1_ops.use_shared_memory(nb, 1),
                "lane0_finite": bool(torch.isfinite(x[0]).all()),
                "lane1_finite": bool(torch.isfinite(x[1]).all())}
        print("phase 8c singular lane: " + json.dumps(sing), flush=True)
        k1["c_singular"] = sing
        # (d) the sweep of ragged shapes
        t0 = time.perf_counter()
        k1["d_sweep"] = _sweep(torch)
        k1["d_sweep"]["wall_s"] = time.perf_counter() - t0
        print("phase 8d K1 vs plain, ragged shapes, B=2: "
              + json.dumps(k1["d_sweep"]), flush=True)
        out["k1"] = k1
        if any(not v["lane0_finite"] or v["lane1_finite"]
               for v in sing.values()):
            _fail("phase 8c: a singular block must give non-finite output "
                  "in its lane only")
        if k1["d_sweep"]["disagree"]:
            _fail("phase 8d: K1 and the plain version disagree at "
                  f"{k1['d_sweep']['disagree']}")
        for name, r in (("a_bench_newton", k1["a_bench_newton"]),
                        ("a_bench_newton r=1",
                         k1["a_bench_newton"]["solve_r1"]),
                        ("b_random_nb200", k1["b_random_nb200"])):
            if not r["finite"] or r["max_lane_rel_err"] > KERNEL_RTOL:
                _fail(f"phase 8 {name}: K1 and the plain version disagree")
        a, b = k1["a_bench_newton"], k1["b_random_nb200"]
        for kern, part, line in (("btb_factor", "factor", 337),
                                 ("btb_solve", "solve", 367)):
            kernels.append({
                "name": kern, "route": "cuda",
                "source": "opensim_moco_tpu_torch/csrc/btb.cu",
                "replaces": f"opensim_moco_tpu/solver/structured.py:{line}",
                "shape": "B32_N25_nb34_k1" + ("_r3" if part == "solve"
                                              else ""),
                "launches": launches.get(kern, 0),
                "max_abs_err": a["max_abs_err"], **_kernel_times(a, part),
                "B8_N16_nb200_k4" + ("_r3" if part == "solve" else ""): {
                    "max_abs_err": b["max_abs_err"], **_kernel_times(b, part)}})
        a1 = a["solve_r1"]
        kernels[-1]["B32_N25_nb34_k1_r1"] = {
            "max_abs_err": a1["max_abs_err"], **_kernel_times(a1, "solve")}

    # ---- phase 9: card against CPU, iterate level, structured
    if 9 in phases:
        phase_start[9] = time.perf_counter()
        par = _iterate_parity(torch, tr, opts_st, z0, Z0)
        print("phase 9 iterate parity cuda vs cpu after 3 steps, "
              "kkt=structured: " + json.dumps(par), flush=True)
        out["iterate_parity_structured"] = par
        if max(par["max_lane_rel_err"].values()) > ITERATE_RTOL or \
                not all(par["exact"].values()):
            _fail("phase 9: card and CPU iterates disagree")

    # ---- the constrained lanes (phases 10-14)
    newton = {}  # K1 checks on the Newton blocks of phases 10 and 13
    if phases & {10, 11, 14}:
        tr10 = double_pendulum_swingup_study(
            25, with_path_constraint=True).transcription()
        z10 = tr10.initial_guess()
        Z10 = batch_guesses(tr10, 32, scale=0.05, seed=0)
        opts10 = IPMOptions(max_iter=200, kkt="structured", **bench)
    res10 = None

    # ---- phase 10: swing-up with its path constraint, K1 throughout
    if 10 in phases:
        phase_start[10] = time.perf_counter()
        res10, stats10 = _solve_lane(torch, tr10, opts10, z10, Z10, dev,
                                     LAUNCHES)
        stats10.update(_kkt_shape(tr10))
        print("phase 10 swing-up with path constraint, kkt=structured "
              "(mesh 25, B=32, f64, cuda): " + json.dumps(stats10),
              flush=True)
        out["swingup_structured"] = stats10
        _check_lanes("phase 10", stats10)
        key, chk = _newton_k1(torch, "phase 10 swing-up", tr10, opts10, Z10,
                              stats10["launches"])
        newton[key] = chk

    # ---- phase 11: the same lane, dense chol-schur KKT
    if 11 in phases:
        phase_start[11] = time.perf_counter()
        # no lane converges under chol-schur (8 of 8 ran to max_iter 200)
        opts11 = dataclasses.replace(opts10, kkt="dense", max_iter=15,
                                     dense_factorization="chol-schur")
        res11, stats11 = _solve_lane(torch, tr10, opts11, z10, Z10[:8], dev)
        print("phase 11 swing-up, kkt=dense chol-schur (mesh 25, B=8, "
              "max_iter 15, f64, cuda): " + json.dumps(stats11), flush=True)
        out["swingup_chol_schur"] = stats11
        if res10 is not None:
            both = res10.converged[:8].cpu().numpy() & \
                res11.converged.cpu().numpy()
            f10, f11 = res10.f[:8].cpu().numpy(), res11.f.cpu().numpy()
            rel = np.abs(f11 - f10) / np.abs(f10)
            worst = float(rel[both].max()) if both.any() else 0.0
            print(f"phase 11 lanes 0-7 converged in phases 10 and 11: "
                  f"{int(both.sum())}, max objective rel diff {worst}",
                  flush=True)
            if worst > 1e-2:
                _fail("phase 11: structured and chol-schur objectives "
                      "differ by more than 1e-2")

    # ---- phase 12: Kirk minimum effort (the generalized spring)
    if 12 in phases:
        phase_start[12] = time.perf_counter()
        tr12 = kirk_min_effort_study(50).transcription()
        opts12 = IPMOptions(tol=1e-7, max_iter=300, kkt="structured")
        res12, stats12 = _solve_lane(
            torch, tr12, opts12, tr12.initial_guess(),
            batch_guesses(tr12, 8, scale=0.05, seed=0), dev, LAUNCHES)
        errs = [float(np.abs(Y[:, :2] - kirk_expected(ts)).max())
                for ts, Y, _, _ in _lane_iterates(res12, tr12)]
        stats12["max_state_err"] = max(errs, default=None)
        print("phase 12 Kirk minimum effort, kkt=structured (mesh 50, B=8, "
              "f64, cuda): " + json.dumps(stats12), flush=True)
        out["kirk_structured"] = stats12
        _check_lanes("phase 12", stats12)
        if max(errs) > 1e-5:
            _fail(f"phase 12: states {max(errs)} from the analytic ones")

    # ---- phase 13: kinematic constraint and parameter lanes
    if phases & {13, 14}:
        tr13 = coupler_pendulum_study(15).transcription()
        Z13 = batch_guesses(tr13, 8, scale=0.05, seed=0)
        opts13 = IPMOptions(tol=1e-6, max_iter=500, kkt="structured")
    if 13 in phases:
        phase_start[13] = time.perf_counter()
        res13, stats13 = _solve_lane(torch, tr13, opts13,
                                     tr13.initial_guess(), Z13, dev,
                                     LAUNCHES)
        stats13.update(_kkt_shape(tr13))
        errs = [float(np.abs(Y[:, 1] - Y[:, 0]).max())
                for _, Y, _, _ in _lane_iterates(res13, tr13)]
        stats13["max_q1_minus_q0"] = max(errs, default=None)
        print("phase 13 coupler pendulum, kkt=structured (mesh 15, B=8, "
              "f64, cuda): " + json.dumps(stats13), flush=True)
        out["coupler_structured"] = stats13
        _check_lanes("phase 13 coupler", stats13)
        if max(errs) > 1e-6:
            _fail(f"phase 13: |q1 - q0| = {max(errs)} > 1e-6")
        key, chk = _newton_k1(torch, "phase 13 coupler", tr13, opts13, Z13,
                              stats13["launches"])
        newton[key] = chk

        tr13o = oscillator_mass_study(40, "endpoint_constraint"
                                      ).transcription()
        Z13o = batch_guesses(tr13o, 8, scale=0.05, seed=0)
        opts13o = IPMOptions(tol=1e-8, max_iter=500, kkt="structured")
        res13o, stats13o = _solve_lane(torch, tr13o, opts13o,
                                       tr13o.initial_guess(), Z13o, dev,
                                       LAUNCHES)
        stats13o.update(_kkt_shape(tr13o))
        errs = [float(abs(theta[0] - 1.0))
                for _, _, _, theta in _lane_iterates(res13o, tr13o)]
        stats13o["max_mass_err"] = max(errs, default=None)
        print("phase 13 oscillator mass, kkt=structured (mesh 40, B=8, f64, "
              "cuda): " + json.dumps(stats13o), flush=True)
        out["oscillator_structured"] = stats13o
        _check_lanes("phase 13 oscillator", stats13o)
        if max(errs) > 1e-3:
            _fail(f"phase 13: |m - 1| = {max(errs)} > 1e-3")
        key, chk = _newton_k1(torch, "phase 13 oscillator", tr13o, opts13o,
                              Z13o, stats13o["launches"])
        newton[key] = chk

    # ---- phase 14: card against CPU, iterate level, constrained lanes
    if 14 in phases:
        phase_start[14] = time.perf_counter()
        par14 = {
            "swingup": _iterate_parity(torch, tr10, opts10, z10, Z10,
                                       COUNTERS, stepwise=True),
            "coupler": _iterate_parity(torch, tr13, opts13,
                                       tr13.initial_guess(), Z13, COUNTERS,
                                       stepwise=True)}
        print("phase 14 iterate parity cuda vs cpu, 3 steps, "
              "kkt=structured: " + json.dumps(par14), flush=True)
        out["iterate_parity_constrained"] = par14
        for name, par in par14.items():
            if max(par["stepwise_max_lane_rel_err"].values()) > \
                    ITERATE_RTOL or not all(par["exact"].values()):
                _fail(f"phase 14 {name}: card and CPU iterates disagree")

    # ---- phase 15: hanging-muscle inverse, dense then structured
    if 15 in phases:
        phase_start[15] = time.perf_counter()
        st15 = hanging_muscle_inverse(0.02).build_study()
        tr15 = st15.transcription()
        z15 = tr15.initial_guess()
        Z15 = batch_guesses(tr15, 32, scale=0.05, seed=0)
        res15 = {}
        for mode in ("dense", "structured"):
            res15[mode], stats15 = _solve_lane(
                torch, tr15, _inverse_options(st15, mode), z15, Z15, dev,
                LAUNCHES)
            stats15.update(_kkt_shape(tr15))
            print(f"phase 15 hanging-muscle inverse, kkt={mode} (mesh "
                  "interval 0.02, B=32, max_iter 300, f64, cuda): "
                  + json.dumps(stats15), flush=True)
            out[f"hanging_inverse_{mode}"] = stats15
            if mode == "structured":
                _check_lanes("phase 15 structured", stats15)
            elif stats15["converged"] == 0:
                _fail("phase 15 dense: no lane converged")
        both = (res15["dense"].converged & res15["structured"].converged
                ).cpu().numpy()
        f_d = res15["dense"].f.cpu().numpy()
        f_s = res15["structured"].f.cpu().numpy()
        rel = np.abs(f_s - f_d) / np.abs(f_d)
        worst = float(rel[both].max()) if both.any() else 0.0
        print(f"phase 15 lanes converged under dense and structured: "
              f"{int(both.sum())}, max objective rel diff {worst}",
              flush=True)
        if worst > 1e-2:
            _fail("phase 15: dense and structured objectives differ by more "
                  "than 1e-2")
        key, chk = _newton_k1(torch, "phase 15 hanging inverse", tr15,
                              _inverse_options(st15, "structured"), Z15,
                              out["hanging_inverse_structured"]["launches"])
        newton[key] = chk

    # ---- phase 16: the six-muscle arm's inverse through K1
    if 16 in phases:
        phase_start[16] = time.perf_counter()
        st16 = _arm_inverse(0.02).build_study()
        tr16 = st16.transcription()
        z16 = tr16.initial_guess()
        Z16 = batch_guesses(tr16, 32, scale=0.05, seed=0)
        opts16 = _inverse_options(st16, "auto")
        res16, stats16 = _solve_lane(torch, tr16, opts16, z16, Z16, dev,
                                     LAUNCHES)
        stats16.update(_kkt_shape(tr16))
        reserves = [i for i, n in enumerate(tr16.rep.control_names)
                    if "reserve" in n]
        stats16["max_abs_reserve"] = max(
            (float(np.abs(X[:, reserves]).max())
             for _, _, X, _ in _lane_iterates(res16, tr16)), default=None)
        print("phase 16 arm inverse, kkt=auto (mesh interval 0.02, B=32, "
              "max_iter 300, f64, cuda): " + json.dumps(stats16), flush=True)
        out["arm_inverse_auto"] = stats16
        _check_lanes("phase 16", stats16)
        key, chk = _newton_k1(torch, "phase 16 arm inverse", tr16, opts16,
                              Z16, stats16["launches"])
        newton[key] = chk
        pad16 = _padding_cost(torch, 32, stats16["N"],
                              (stats16["nb_inner"], stats16["nb"]),
                              stats16["k"], 20)
        print("phase 16 K1 on random blocks at the arm's inner and padded "
              "widths (B=32): " + json.dumps(pad16), flush=True)
        out["arm_inverse_padding"] = pad16
        par16 = _iterate_parity(torch, tr16, opts16, z16, Z16[:4], COUNTERS,
                                stepwise=True)
        print("phase 16 iterate parity cuda vs cpu, lanes 0-3, 3 steps, "
              "kkt=auto: " + json.dumps(par16), flush=True)
        out["iterate_parity_arm_inverse"] = par16
        if max(par16["stepwise_max_lane_rel_err"].values()) > ITERATE_RTOL \
                or not all(par16["exact"].values()):
            _fail("phase 16: card and CPU iterates disagree")

    # ---- phases 17 and 18: the contact leg through K1
    if phases & {17, 18}:
        tr17 = contact_leg_study(50).transcription()
        z17 = tr17.initial_guess()
        Z17 = batch_guesses(tr17, 32, scale=0.05, seed=0)
        # the bench's options with objective-only curvature, as the JAX
        # bench's gait2d lane (bench.py:106-110): from the jittered
        # bounds-midpoint starts the exact Hessian's contact curvature
        # drives the regularization up until steps stall
        opts17 = IPMOptions(max_iter=3, kkt="structured",
                            hessian_approximation="objective-only", **bench)
    if 17 in phases:
        phase_start[17] = time.perf_counter()
        res17, stats17 = _solve_lane(torch, tr17, opts17, z17, Z17, dev,
                                     LAUNCHES)
        stats17.update(_kkt_shape(tr17))
        print("phase 17 contact leg, kkt=structured (mesh 50, B=32, "
              f"max_iter {opts17.max_iter}, f64, cuda; nb is the padded "
              "block width, "
              "nb_inner the widest block but the last; converged lanes "
              "reported, not held): " + json.dumps(stats17), flush=True)
        out["contact_leg_structured"] = stats17
        if min(stats17["launches"].values()) == 0:
            _fail(f"phase 17: a kernel of the path never launched: "
                  f"{stats17['launches']}")
        key, chk = _newton_k1(torch, "phase 17 contact leg", tr17, opts17,
                              Z17, stats17["launches"])
        newton[key] = chk
    if 18 in phases:
        phase_start[18] = time.perf_counter()
        par18 = _iterate_parity(torch, tr17, opts17, z17, Z17[:4], COUNTERS,
                                stepwise=True, steps=2)
        print("phase 18 iterate parity cuda vs cpu, contact leg lanes 0-3, "
              "2 steps, kkt=structured: " + json.dumps(par18), flush=True)
        out["iterate_parity_contact_leg"] = par18
        if max(par18["stepwise_max_lane_rel_err"].values()) > ITERATE_RTOL \
                or not all(par18["exact"].values()):
            _fail("phase 18: card and CPU iterates disagree")

    # ---- phases 19-21: the Track tool
    if phases & {19, 20, 21}:
        st19, g19 = contact_leg_track_study(50)
        tr19 = st19.transcription()
        Z19 = _track_starts(tr19, g19, 32)
        # the tool's options, max_iter cut from 2000 to 200
        opts19 = dataclasses.replace(st19.ipm_options, max_iter=200,
                                     kkt="structured")
    if 19 in phases:
        phase_start[19] = time.perf_counter()
        track, times, q_ref = _point_mass_track()
        t0 = time.perf_counter()
        # unsealed: the report reads the states even if it did not converge
        sol = track.solve().unseal()
        pm = {"success": sol.success, "iterations": sol.num_iterations,
              "wall_s": time.perf_counter() - t0,
              "max_q_err": float(np.abs(sol.state("/jointset/j/q/value") -
                                        np.interp(sol.time, times,
                                                  q_ref)).max()),
              "max_control_err": float(np.abs(
                  sol.control("/forceset/act") -
                  np.sin(2 * np.pi * sol.time))[3:-3].max())}
        print("phase 19 point mass Track.solve() (mesh 40, cuda): "
              + json.dumps(pm), flush=True)
        out["track_point_mass"] = pm
        if not sol.success or pm["max_q_err"] > 2e-3 or \
                pm["max_control_err"] > 5e-2:
            _fail("phase 19: Track.solve() did not recover the point mass's "
                  "motion and control")
        res19, stats19 = _solve_lane(torch, tr19, opts19, g19, Z19, dev,
                                     LAUNCHES)
        stats19.update(_kkt_shape(tr19))
        f19 = res19.f.cpu().numpy()[res19.converged.cpu().numpy()]
        stats19["f_converged_min_max"] = ([float(f19.min()),
                                           float(f19.max())]
                                          if f19.size else None)
        stats19["max_rms_coordinate_err"] = _rms_tracking_err(
            res19, tr19, st19.problem.goals[0].reference)
        print("phase 19 contact leg Track, kkt=structured (mesh 50, B=32, "
              "max_iter 200, f64, cuda; lane 0 make_guess): "
              + json.dumps(stats19), flush=True)
        out["contact_leg_track"] = stats19
        _check_lanes("phase 19", stats19)
        key, chk = _newton_k1(torch, "phase 19 contact leg Track", tr19,
                              opts19, Z19, stats19["launches"], z0=g19)
        newton["track_" + key] = chk
    if 20 in phases:
        phase_start[20] = time.perf_counter()
        opts20 = dataclasses.replace(opts19, max_iter=5,
                                     hessian_approximation="exact")
        res20, stats20 = _solve_lane(torch, tr19, opts20, g19, Z19[:8], dev,
                                     LAUNCHES)
        stats20["kkt_error"] = res20.kkt_error.cpu().tolist()
        stats20["iterations"] = res20.iterations.cpu().tolist()
        print("phase 20 contact leg Track, exact Hessian, kkt=structured "
              "(mesh 50, B=8, max_iter 5, f64, cuda; reported, not gated): "
              + json.dumps(stats20), flush=True)
        out["contact_leg_track_exact"] = stats20
        key, chk = _newton_k1(torch, "phase 20 contact leg Track exact",
                              tr19, opts20, Z19[:8], stats20["launches"],
                              z0=g19)
        newton["track_exact_" + key] = chk
    if 21 in phases:
        phase_start[21] = time.perf_counter()
        par21 = _iterate_parity(torch, tr19, opts19, g19, Z19[:4], COUNTERS,
                                stepwise=True, steps=2)
        print("phase 21 iterate parity cuda vs cpu, contact leg Track lanes "
              "0-3, 2 steps, kkt=structured: " + json.dumps(par21),
              flush=True)
        out["iterate_parity_contact_leg_track"] = par21
        if max(par21["stepwise_max_lane_rel_err"].values()) > ITERATE_RTOL \
                or not all(par21["exact"].values()):
            _fail("phase 21: card and CPU iterates disagree")

    # ---- phases 22 and 23: the walker's Track lane
    # the JAX bench's gait2d lane's options (bench.py:105-110), which solve
    # the Track study this walker stands in for
    opts22 = IPMOptions(tol=1e-4, max_iter=WALKER_MAX_ITER, mu_init=1e-2,
                        max_rescues=100, kappa_eps=100.0,
                        acceptable_tol_factor=30.0, acceptable_iter=5,
                        max_ls=6, kkt="structured",
                        hessian_approximation="objective-only")
    res22 = None
    if phases & {22, 23}:
        st22, g22 = walker2d_track_study(50)
        tr22 = st22.transcription()
        Z22 = _track_starts(tr22, g22, WALKER_B)
    if 22 in phases:
        phase_start[22] = time.perf_counter()
        res22, stats22 = _solve_lane(torch, tr22, opts22, g22, Z22, dev,
                                     LAUNCHES)
        stats22.update(_kkt_shape(tr22))
        conv22 = res22.converged.cpu().numpy()
        stats22["lane0_converged"] = bool(conv22[0])
        stats22["iterations"] = res22.iterations.cpu().tolist()
        stats22["kkt_error"] = res22.kkt_error.cpu().tolist()
        f22 = res22.f.cpu().numpy()[conv22]
        stats22["f_converged_min_max"] = ([float(f22.min()),
                                           float(f22.max())]
                                          if f22.size else None)
        stats22["max_rms_coordinate_err"] = _rms_tracking_err(
            res22, tr22, st22.problem.goals[0].reference)
        print(f"phase 22 walker Track, kkt=structured (mesh 50, "
              f"B={WALKER_B}, max_iter {WALKER_MAX_ITER}, f64, "
              "cuda; lane 0 make_guess): " + json.dumps(stats22), flush=True)
        out["walker_track"] = stats22
        if min(stats22["launches"].values()) == 0:
            _fail(f"phase 22: a kernel of the path never launched: "
                  f"{stats22['launches']}")
        key, chk = _newton_k1(torch, "phase 22 walker Track", tr22, opts22,
                              Z22, stats22["launches"], z0=g22)
        newton["walker_track_" + key] = chk
        if not conv22[0]:
            _fail("phase 22: lane 0 (the Track guess) did not converge")
    if 23 in phases:
        phase_start[23] = time.perf_counter()
        par23 = _iterate_parity(torch, tr22, opts22, g22, Z22[:2], COUNTERS,
                                stepwise=True, steps=2)
        print("phase 23 iterate parity cuda vs cpu, walker Track lanes 0-1, "
              "2 steps, kkt=structured: " + json.dumps(par23), flush=True)
        out["iterate_parity_walker_track"] = par23
        if max(par23["stepwise_max_lane_rel_err"].values()) > ITERATE_RTOL \
                or not all(par23["exact"].values()):
            _fail("phase 23: card and CPU iterates disagree")

    # ---- phases 24 and 25: the walker's de-novo prediction
    if phases & {24, 25}:
        if res22 is not None:
            warm_src = "phase 22 lane 0 (Track, mesh 50)"
            warm = _expand_lane(st22, tr22, res22, 0)
        else:
            warm_src = "Track study, mesh 10, phase 22's options"
            st10, g10 = walker2d_track_study(10)
            tr10 = st10.transcription()
            res10 = make_batched_solver(tr10, opts22, dev,
                                        scale_z0=g10)(g10[None])
            warm = _expand_lane(st10, tr10, res10, 0)
        # a tracking solution that did not converge is still a warm start
        warm.unseal()
        st24, _ = walker2d_prediction_study(
            10, max_iterations=WALKER_PREDICT_MAX_ITER)
        tr24 = st24.transcription()
        z24 = tr24.guess_from_trajectory(warm)
    if 24 in phases:
        phase_start[24] = time.perf_counter()
        for name in LAUNCHES:
            LAUNCHES[name] = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        sol24 = st24.solve(guess=warm)
        torch.cuda.synchronize()
        stats24 = {"warm_start": warm_src,
                   "warm_start_converged": bool(warm.success),
                   "warm_start_iterations": warm.num_iterations,
                   "n": tr24.n,
                   "m": sum(size for _, size in tr24.constraint_group_info()),
                   "kkt_structure": None if tr24.kkt_structure() is None
                   else "present", "launches": dict(LAUNCHES),
                   "wall_s": time.perf_counter() - t0,
                   "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                   **_prediction_report(torch, tr24, sol24)}
        stats24["s_per_iteration"] = stats24["wall_s"] / max(
            1, stats24["iterations"])
        print(f"phase 24 walker prediction, dense (mesh 10, B=1, max_iter "
              f"{WALKER_PREDICT_MAX_ITER}, f64, cuda; Study.solve from a "
              "tracking solution): " + json.dumps(stats24), flush=True)
        out["walker_prediction"] = stats24
        if stats24["kkt_structure"] is not None or \
                any(stats24["launches"].values()):
            _fail("phase 24: the prediction left the dense KKT path")
        if not stats24["finite"]:
            _fail("phase 24: non-finite solution")
        slack = st24.ipm_options.bound_relax
        if not 0.4 - slack <= stats24["final_time"] <= 0.6 + slack:
            _fail(f"phase 24: final time {stats24['final_time']} outside "
                  "[0.4, 0.6]")
    if 25 in phases:
        phase_start[25] = time.perf_counter()
        par25 = _iterate_parity(torch, tr24, st24.ipm_options, z24,
                                z24[None], COUNTERS, stepwise=True, steps=2)
        print("phase 25 iterate parity cuda vs cpu, walker prediction, 2 "
              "steps, dense: " + json.dumps(par25), flush=True)
        out["iterate_parity_walker_prediction"] = par25
        if max(par25["stepwise_max_lane_rel_err"].values()) > ITERATE_RTOL \
                or not all(par25["exact"].values()):
            _fail("phase 25: card and CPU iterates disagree")

    # ---- phase 26: the tracking and output goals on the card
    if 26 in phases:
        phase_start[26] = time.perf_counter()
        res26 = _tracking_goals_parity(torch)
        print("phase 26 tracking goals cuda vs cpu (f, grad f, J and "
              "exact-Lagrangian H blocks, 2 lanes): " + json.dumps(res26),
              flush=True)
        out["tracking_goals"] = res26
        if max(res26["max_lane_rel_err"].values()) > KERNEL_RTOL:
            _fail("phase 26: the goals' derivatives on the card and the CPU "
                  "disagree")

    # ---- phases 27-29: the walker's inverse, with wraps and measured GRFs
    res27 = None
    if phases & {27, 28, 29}:
        st27 = walker2d_inverse_study(0.01)
        tr27 = st27.transcription()
        z27 = tr27.initial_guess()
        Z27 = batch_guesses(tr27, WALKER_INVERSE_B, scale=0.05, seed=0)
        Z27[0] = z27
        # the Inverse tool's options, max_iter cut, K1 through "auto"
        opts27 = dataclasses.replace(st27.ipm_options,
                                     max_iter=WALKER_INVERSE_MAX_ITER,
                                     kkt="auto")
    if 27 in phases:
        phase_start[27] = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        res27, stats27 = _solve_lane(torch, tr27, opts27, z27, Z27, dev,
                                     LAUNCHES)
        stats27.update(_kkt_shape(tr27))
        stats27["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        stats27["s_per_iteration"] = stats27["wall_s"] / max(
            1, stats27["max_iterations"])
        conv27 = res27.converged.cpu().numpy()
        stats27["lane0_converged"] = bool(conv27[0])
        stats27["iterations"] = res27.iterations.cpu().tolist()
        stats27["kkt_error"] = res27.kkt_error.cpu().tolist()
        stats27["reserve_share"] = _reserve_share(torch, tr27, res27)
        print(f"phase 27 walker inverse, kkt=auto (mesh interval 0.01, "
              f"B={WALKER_INVERSE_B}, max_iter {WALKER_INVERSE_MAX_ITER}, "
              "f64, cuda; lane 0 the bounds-midpoint guess): "
              + json.dumps(stats27), flush=True)
        out["walker_inverse"] = stats27
        if min(stats27["launches"].values()) == 0:
            _fail(f"phase 27: a kernel of the path never launched: "
                  f"{stats27['launches']}")
        key, chk = _newton_k1(torch, "phase 27 walker inverse", tr27, opts27,
                              Z27, stats27["launches"])
        newton["walker_inverse_" + key] = chk
        if not conv27[0]:
            _fail("phase 27: lane 0 (the bounds-midpoint guess) did not "
                  "converge")
    if 28 in phases:
        phase_start[28] = time.perf_counter()
        par28 = _iterate_parity(torch, tr27, opts27, z27, Z27[:2], COUNTERS,
                                stepwise=True, steps=2)
        print("phase 28 iterate parity cuda vs cpu, walker inverse lanes "
              "0-1, 2 steps, kkt=auto: " + json.dumps(par28), flush=True)
        out["iterate_parity_walker_inverse"] = par28
        if max(par28["stepwise_max_lane_rel_err"].values()) > ITERATE_RTOL \
                or not all(par28["exact"].values()):
            _fail("phase 28: card and CPU iterates disagree")
    if 29 in phases:
        phase_start[29] = time.perf_counter()
        res29 = _walker_model_parity(torch, tr27, res27)
        res29["joint_reaction_goal"] = _joint_reaction_goal_parity(
            torch, walker2d_track_study)
        print("phase 29 wrapping walker cuda vs cpu (path kinematics, "
              "moment arms, f_app with the GRFs, joint reactions; a "
              "JointReactionGoal's f, grad f, J and exact-Lagrangian H "
              "blocks): "
              + json.dumps(res29), flush=True)
        out["walker_model_parity"] = res29
        worst = max(max(res29["max_rel_err"].values()), max(
            res29["joint_reaction_goal"]["max_lane_rel_err"].values()))
        if worst > MODEL_RTOL:
            _fail(f"phase 29: card and CPU disagree by {worst}")

    # ---- phase 30: the Study's checkpoints, guesses and diagnostics
    if 30 in phases:
        phase_start[30] = time.perf_counter()
        st30 = kirk_min_effort_study(50)
        st30.set_ipm_options(tol=1e-7, max_iter=200, kkt="structured")
        with tempfile.TemporaryDirectory() as tmp:
            kirk30, launches30 = _study_kirk(torch, tmp, st30)
        print("phase 30 Kirk Study.solve checkpointed every 5, warm start "
              "from the file, interrupt file gone (mesh 50, B=1, tol 1e-7, "
              "kkt=structured, cuda): " + json.dumps(kirk30), flush=True)
        out["study_kirk"] = kirk30
        if not kirk30["converged"] or not kirk30["file_written"] or \
                kirk30["max_state_err"] > 1e-5:
            _fail("phase 30: Kirk's checkpointed solve did not converge to "
                  "the analytic states or wrote no file")
        w = kirk30["warm"]
        if not w["converged"] or \
                w["iterations"] > kirk30["iterations"] + 2 or \
                w["objective_diff"] >= 1e-6:
            _fail(f"phase 30: the warm start from the checkpoint: {w}")
        if kirk30["interrupted_iterations"] > 6:
            _fail("phase 30: the solve ran past its first chunks with the "
                  "interrupt file gone")
        if min(launches30.values()) == 0:
            _fail(f"phase 30: a kernel of the path never launched: "
                  f"{launches30}")
        tr30 = st30.transcription()
        z30 = tr30.initial_guess()
        key, chk = _newton_k1(torch, "phase 30 Kirk Study", tr30,
                              st30.ipm_options, z30[None], launches30,
                              z0=z30)
        newton["study_kirk_" + key] = chk
        # the bench lane: the guesses and the diagnostics, card and CPU
        st30b = hanging_muscle_study(25, ignore_tendon_compliance=False,
                                     ignore_activation_dynamics=False,
                                     tendon_dynamics_implicit=True)
        tr30b = st30b.transcription()
        bench30 = _guess_parity(torch, st30b)
        if res7 is not None:
            bench30["iterate"] = "phase 7 lane 0"
            sol30 = _expand_lane(st30b, tr30b, res7, 0)
        else:
            bench30["iterate"] = "the first jittered start"
            sol30 = types.SimpleNamespace(raw_iterate=Z0[0])
        nq = tr30b.rep.model.nq

        def accel(rep, t, y, x, lam, p):
            q, u, z = rep.model.split_state(y)
            udot = rep.model.multibody_explicit(p, t, q, u, z, x, lam)
            return udot[..., 0]

        def path(rep, t, y, x, lam, p):
            return torch.cat(rep.model.muscle_path_kinematics(
                p, y[..., :nq], y[..., nq:2 * nq]), -1)

        bench30["diagnostics"] = _diagnostics_parity(
            st30b, sol30, {"accel": accel, "path": path})
        print("phase 30 bench lane create_guess, objective_breakdown, "
              "constraint_report and analyze cuda vs cpu (mesh 25): "
              + json.dumps(bench30), flush=True)
        out["study_bench"] = bench30
        if not bench30["bounds_equal"] or not bench30["random_equal"] or \
                bench30["time_stepping_rel_err"] > 1e-9 or \
                not bench30["time_stepping_finite"] or \
                not bench30["time_stepping_in_bounds"]:
            _fail("phase 30: the bench lane's guesses on the card and the "
                  "CPU disagree")
        if max(bench30["diagnostics"]["max_rel_err"].values()) > \
                KERNEL_RTOL:
            _fail("phase 30: the bench lane's diagnostics on the card and "
                  "the CPU disagree")

    # ---- phase 31: the walker's Track study through Study.solve
    if 31 in phases:
        phase_start[31] = time.perf_counter()
        st31, g31 = walker2d_track_study(50)
        st31.ipm_options = dataclasses.replace(
            opts22, max_iter=WALKER_STUDY_MAX_ITER)
        warm31 = None
        if res22 is not None:
            warm31 = _expand_lane(st22, tr22, res22, 0)
        with tempfile.TemporaryDirectory() as tmp:
            walker31, launches31 = _walker_study(torch, tmp, st31, g31,
                                                 warm31)
        walker31["round_trip"]["source"] = (
            "phase 22 lane 0" if warm31 is not None
            else "this phase's checkpointed solve")
        print(f"phase 31 walker Track through Study.solve (mesh 50, B=1, "
              f"max_iter {WALKER_STUDY_MAX_ITER}, phase 22's options, "
              "cuda): " + json.dumps(walker31), flush=True)
        out["walker_study"] = walker31
        c, p = walker31["chunked"], walker31["plain"]
        if c["iterations"] != p["iterations"] or \
                c["kkt_error"] != p["kkt_error"] or \
                walker31["chunked_vs_plain_z_rel_err"] > 1e-12:
            _fail("phase 31: the chunked and the plain solve differ")
        if walker31["checkpoint_rel_err"] > 1e-14:
            _fail("phase 31: the checkpoint does not read back to the "
                  "solution")
        if walker31["round_trip"]["max_abs_err"] > 1e-12:
            _fail("phase 31: the .sto round trip moved the iterate")
        d = walker31["diagnostics"]
        if max(d["max_rel_err"].values()) > KERNEL_RTOL or \
                d["breakdown_sum_rel_err"] > KERNEL_RTOL:
            _fail("phase 31: the walker's diagnostics on the card and the "
                  "CPU disagree")
        ts31 = walker31["time_stepping"]
        if not ts31["finite"] or ts31["first_intervals_rel_err"] > 1e-8:
            _fail("phase 31: the walker's time-stepping guess on the card "
                  "and the CPU disagree")
        if min(launches31.values()) == 0:
            _fail(f"phase 31: a kernel of the path never launched: "
                  f"{launches31}")
        tr31 = st31.transcription()
        key, chk = _newton_k1(torch, "phase 31 walker Study", tr31,
                              st31.ipm_options, g31[None], launches31,
                              z0=g31)
        newton["walker_study_" + key] = chk

    # the K1 checks of phases 10, 13, 15, 16, 17, 19, 20, 22, 27, 30 and 31
    # join the kernels line by shape
    for key, chk in newton.items():
        if not kernels:  # phase 8 not run: these shapes lead
            kernels = [{"name": kern, "route": "cuda",
                        "source": "opensim_moco_tpu_torch/csrc/btb.cu",
                        "replaces": "opensim_moco_tpu/solver/structured.py:"
                        f"{line}", "shape": key + ("_r1" if part == "solve"
                                                   else ""),
                        "launches": chk["launches"][kern],
                        "max_abs_err": chk["max_abs_err"],
                        **_kernel_times(chk, part)}
                       for kern, part, line in (("btb_factor", "factor", 337),
                                                ("btb_solve", "solve", 367))]
        for entry, part in zip(kernels, ("factor", "solve")):
            entry[key + ("_r1" if part == "solve" else "")] = {
                "launches": chk["launches"][entry["name"]],
                "max_abs_err": chk["max_abs_err"],
                **_kernel_times(chk, part)}

    marks = sorted(phase_start.items())
    ends = [t for _, t in marks[1:]] + [time.perf_counter()]
    print("phase wall seconds: " + json.dumps(
        {str(n): e - t for (n, t), e in zip(marks, ends)}), flush=True)

    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
