"""Where an iteration of the port's batched IPM spends its time, per KKT mode.

For one lane, B=32, float64, the bench's IPM options (``--lane hanging``:
the bench's full-dynamics hanging muscle at mesh 25; ``--lane
contact_leg``: ``examples.contact_leg_study(50)`` with objective-only
curvature, as ``chip_smoke.py`` phase 17 solves it; ``--lane
contact_leg_track``: ``examples.contact_leg_track_study(50)`` from
``chip_smoke.py`` phase 19's starts, scaled at the tool's guess, with
objective-only curvature; ``--lane walker_track``: the same for
``examples.walker2d_track_study(50)``, phase 22's lane; ``--lane
walker_predict``: ``examples.walker2d_prediction_study(10)`` with its own
IPM options, every lane warm-started from the walker's reference motion
(``examples.walker2d_reference_trajectory``), as ``chip_smoke.py`` phase
24 solves it from a tracking solution; its problem has no KKT structure,
so every mode is the dense path) and each ``kkt`` mode ("dense", "auto",
"structured"), on one CUDA card (``--batch`` lanes in place of 32):

* seconds per ``body_fn`` call (host clock around 5 calls ending in
  ``torch.cuda.synchronize()``, after ``init_fn`` and 3 warm-up steps);
* a ``torch.profiler`` trace of 3 further steps: kernel launches, the
  device's busy and idle share (busy = the union of the kernels' device
  intervals), the kernels with the most device time, and K1's (the
  ``btb_factor_*kernel`` and ``btb_solve_*kernel`` kernels of
  ``csrc/btb.cu``) device time and its share of the busy time;

and, at the same 32 starting points, the derivative passes timed alone:
dense ``vmap(jacfwd(c))`` and ``vmap(jacfwd(grad(L)))`` (hanging lane
only: the contact leg's dense Hessian pass would hold 32 x 2628 seeds of
its whole graph) against the compressed ``jac_blocks`` and
``hess_blocks`` (of the Lagrangian, and of the objective alone, the
curvature the leg's lanes use); on the prediction lane the dense
``vmap(jacfwd(c))`` and the objective's ``vmap(jacfwd(grad(f)))``, the
passes of its iteration; on the ``Track`` lane also the same
passes with its ``MarkerTrackingGoal`` taken out (``without_markers``),
so that their difference is the marker goal's cost.

Prints one JSON object per line. Run from the root of the repository::

    python3 scripts/profile_torch_iteration.py [--out profile.json] \
        [--modes dense,auto,structured] \
        [--lane hanging|contact_leg|contact_leg_track|walker_track|\
walker_predict] [--batch 32]
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.func import grad, jacfwd, vmap

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import _track_starts  # noqa: E402
from opensim_moco_tpu_torch.config import full_precision  # noqa: E402
from opensim_moco_tpu_torch.examples import (  # noqa: E402
    contact_leg_study, contact_leg_track_study, hanging_muscle_study,
    walker2d_prediction_study, walker2d_reference_trajectory,
    walker2d_track_study)
from opensim_moco_tpu_torch.parallel import batch_guesses  # noqa: E402
from opensim_moco_tpu_torch.solver.ipm import (  # noqa: E402
    IPMOptions, make_kernel)
from opensim_moco_tpu_torch.solver.kkt import CompiledStructure  # noqa: E402
from opensim_moco_tpu_torch.solver.structured import (  # noqa: E402
    BlockDerivatives)

BENCH = dict(tol=3e-3, max_iter=200, bound_relax=1e-6, mu_init=1e-2,
             kappa_eps=100.0, acceptable_tol_factor=30.0, acceptable_iter=10,
             max_rescues=100)


def _host_s(fn, reps):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps


def _busy_share(prof):
    """(kernel launches, device busy s, window s) from a profiler trace."""
    spans, launches = [], 0
    t_lo, t_hi = np.inf, -np.inf
    for ev in prof.events():
        t_lo = min(t_lo, ev.time_range.start)
        t_hi = max(t_hi, ev.time_range.end)
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            spans.append((ev.time_range.start, ev.time_range.end))
        elif ev.name in ("cudaLaunchKernel", "cuLaunchKernel",
                         "cudaLaunchKernelExC", "cuLaunchKernelEx"):
            launches += 1
    busy, end = 0.0, -np.inf
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return launches, busy * 1e-6, (t_hi - t_lo) * 1e-6


def profile_mode(tr, Z0, z0, mode, options, dev="cuda"):
    nlp = tr.make_nlp(dev)
    init_fn, body_fn, _, _ = make_kernel(
        nlp, dataclasses.replace(options, kkt=mode), scale_z0=z0,
        device=dev)
    with full_precision(dev):
        carry = init_fn(Z0)
        for _ in range(3):
            carry = body_fn(carry)
        state = [carry]

        def step():
            state[0] = body_fn(state[0])

        s_iter = _host_s(step, 5)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                step()
            torch.cuda.synchronize()
    launches, busy, window = _busy_share(prof)
    kernels = [(e.key, e.self_device_time_total * 1e-6, e.count)
               for e in prof.key_averages() if e.self_device_time_total > 0]
    top = sorted(kernels, key=lambda r: -r[1])[:8]
    k1 = {name: (s, c) for name, s, c in kernels
          if any(f"btb_{kind}" in name and "_kernel" in name
                 for kind in ("factor", "solve"))}
    k1_s = sum(s for s, _ in k1.values())
    return {"mode": mode, "body_fn_s": s_iter,
            "profiled_steps": 3, "kernel_launches": launches,
            "device_busy_s": busy, "window_s": window,
            "device_idle_share": 1.0 - busy / window,
            "k1_device_s": k1_s, "k1_share_of_busy": k1_s / busy,
            "k1": [{"name": k[:80], "s": s, "count": c}
                   for k, (s, c) in k1.items()],
            "top_device_s": [{"name": k[:80], "s": s, "count": c}
                             for k, s, c in top]}


def dense_passes(tr, Z0, dev="cuda"):
    """The dense derivative passes of an NLP without a KKT structure: the
    constraint Jacobian and the objective's Hessian (objective-only
    curvature)."""
    nlp = tr.make_nlp(dev)
    z = torch.as_tensor(Z0, device=dev)
    with full_precision(dev):
        return {"n": nlp.n, "m": nlp.m,
                "c_s": _host_s(lambda: nlp.constraints(z), 5),
                "f_s": _host_s(lambda: nlp.objective(z), 5),
                "dense_J_s": _host_s(
                    lambda: vmap(jacfwd(nlp.constraints))(z), 3),
                "dense_H_objective_s": _host_s(
                    lambda: vmap(jacfwd(grad(nlp.objective)))(z), 3)}


def derivative_passes(tr, Z0, dense=True, dev="cuda"):
    """Dense (with ``dense``) and compressed derivative passes at the same
    points (the NLP as transcribed: no scaling, fixed variables kept)."""
    nlp = tr.make_nlp(dev)
    st = nlp.structure
    cs = CompiledStructure(st.var_blocks, st.con_blocks, st.border_vars,
                           st.border_cons, nlp.n, nlp.m)
    bd = BlockDerivatives(cs, nlp.constraints, dev)
    z = torch.as_tensor(Z0, device=dev)
    nu = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (len(Z0), nlp.m)), device=dev)

    def lag(zz, nn):
        return nlp.objective(zz) + (nlp.constraints(zz) * nn).sum(-1)

    def lag_grad(zz, nn):
        return grad(lambda q: lag(q, nn).sum())(zz)

    with full_precision(dev):
        out = {"n": nlp.n, "m": nlp.m, "N": cs.N, "nv": cs.nv, "nc": cs.nc,
               "jac_seeds": int(bd.SJ.shape[0]),
               "hess_seeds": int(bd.SH.shape[0]),
               "c_s": _host_s(lambda: nlp.constraints(z), 5),
               "f_s": _host_s(lambda: nlp.objective(z), 5)}
        if dense:
            out["dense_J_s"] = _host_s(
                lambda: vmap(jacfwd(nlp.constraints))(z), 5)
            out["dense_W_s"] = _host_s(
                lambda: vmap(jacfwd(grad(lag)))(z, nu), 5)
        out["jac_blocks_s"] = _host_s(lambda: bd.jac_blocks(z), 5)
        out["hess_blocks_s"] = _host_s(
            lambda: bd.hess_blocks(lag_grad, z, nu), 5)
        out["grad_f_s"] = _host_s(
            lambda: grad(lambda q: nlp.objective(q).sum())(z), 5)
        out["hess_blocks_objective_s"] = _host_s(lambda: bd.hess_blocks(
            lambda zz, nn: grad(lambda q: nlp.objective(q).sum())(zz),
            z, nu), 5)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the results to this JSON file")
    ap.add_argument("--modes", default="dense,auto,structured")
    ap.add_argument("--lane", default="hanging",
                    choices=("hanging", "contact_leg", "contact_leg_track",
                             "walker_track", "walker_predict"))
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("this profile needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    if args.lane == "hanging":
        tr = hanging_muscle_study(
            25, ignore_tendon_compliance=False,
            ignore_activation_dynamics=False,
            tendon_dynamics_implicit=True).transcription()
    elif args.lane == "contact_leg":
        tr = contact_leg_study(50).transcription()
    if args.lane in ("contact_leg_track", "walker_track"):
        study, z0 = (contact_leg_track_study if args.lane ==
                     "contact_leg_track" else walker2d_track_study)(50)
        tr = study.transcription()
        Z0 = _track_starts(tr, z0, args.batch)
    elif args.lane == "walker_predict":
        study, z0 = walker2d_prediction_study(
            10, guess=walker2d_reference_trajectory())
        tr = study.transcription()
        Z0 = np.repeat(z0[None], args.batch, 0)
    else:
        z0 = tr.initial_guess()
        Z0 = batch_guesses(tr, args.batch, scale=0.05, seed=0)
    results = {"card": card, "lane": args.lane, "batch": args.batch,
               "derivatives":
               dense_passes(tr, Z0) if args.lane == "walker_predict" else
               derivative_passes(tr, Z0, dense=args.lane == "hanging")}
    print(json.dumps(results["derivatives"]), flush=True)
    if args.lane == "contact_leg_track":
        study.problem.goals = [g for g in study.problem.goals
                               if g.name != "marker_tracking"]
        results["without_markers"] = derivative_passes(
            study.transcription(), Z0, dense=False)
        print(json.dumps({"without_markers": results["without_markers"]}),
              flush=True)
    if args.lane == "walker_predict":
        options = study.ipm_options
    else:
        options = IPMOptions(**BENCH, **({} if args.lane == "hanging" else
                                         {"hessian_approximation":
                                          "objective-only"}))
    for mode in args.modes.split(","):
        results[mode] = profile_mode(tr, Z0, z0, mode, options)
        print(json.dumps(results[mode]), flush=True)
    if args.out:
        Path(args.out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
