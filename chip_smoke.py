"""Drive the PyTorch port's main path once on one CUDA card.

The main path is a batched interior-point solve of the hanging-muscle
minimum-time problem (a DeGrooteFregly2016 muscle lifting a 0.5 kg mass)
through ``opensim_moco_tpu_torch.parallel.make_batched_solver``, in
float64, at the bench configuration: Hermite-Simpson at 25 mesh
intervals, 32 jittered starts, the bench's IPM options with the dense KKT.

Phases, one report line each:

1. device: the card's name and power limit; no card, no run;
2. full-dynamics lane (activation + implicit tendon compliance), B=32 on
   the card: converged, strict, mean/max iterations, wall seconds;
3. card against CPU, iterate level: ``init_fn`` and 3 ``body_fn`` steps on
   both devices for the same 32 lanes; z, nu, wL and wU agree per lane to
   1e-6 of their magnitude, mu and the iteration counters exactly;
4. card against CPU, solve level: lanes 0-3 solved to the end on the CPU;
   every lane that converges there converges on the card, with the
   objective within relative 1e-2;
5. simplified lane (rigid tendon, no activation dynamics), B=32 on the
   card.

The port has no hand-written kernel yet, so the kernel list is empty.
The last line of standard output is the result object. Run from the root
of the repository::

    python3 chip_smoke.py [--out results.json]
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np


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


def _solve_lane(torch, tr, opts, z0, Z0, dev):
    """Warm up on two lanes for two iterations, then time the batch."""
    from opensim_moco_tpu_torch.parallel import make_batched_solver

    warm = make_batched_solver(tr, dataclasses.replace(opts, max_iter=2),
                               dev, scale_z0=z0)
    warm(Z0[:2])
    solve = make_batched_solver(tr, opts, dev, scale_z0=z0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(Z0)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for name, v in res._asdict().items():
        if v.device.type != "cuda":
            _fail(f"result field {name} is on {v.device}, not cuda")
    return res, _batch_stats(res, opts.tol, dt)


def _lane_rel_err(a, b):
    """max over lanes of max|a - b| / max|b| (lane by lane)."""
    a = a.cpu().numpy()
    b = b.cpu().numpy()
    if b.shape[-1] == 0:
        return 0.0
    scale = np.maximum(np.abs(b).max(-1), 1e-300)
    return float((np.abs(a - b).max(-1) / scale).max())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the phase results to this "
                    "JSON file")
    args = ap.parse_args()

    import torch

    # ---- phase 1: device
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this check needs a CUDA "
              "card and has no CPU fallback")
    from opensim_moco_tpu_torch.config import full_precision
    from opensim_moco_tpu_torch.examples import hanging_muscle_study
    from opensim_moco_tpu_torch.parallel import (batch_guesses,
                                                 make_batched_solver)
    from opensim_moco_tpu_torch.solver.ipm import IPMOptions, make_kernel

    card = _card_line()
    kind = torch.cuda.get_device_name(0)
    print(card)
    print(f"phase 1 device: {kind} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | count {torch.cuda.device_count()}",
          flush=True)
    dev = torch.device("cuda")
    out = {"card": card, "kind": kind, "torch": torch.__version__}

    bench = dict(tol=3e-3, bound_relax=1e-6, mu_init=1e-2, kappa_eps=100.0,
                 acceptable_tol_factor=30.0, acceptable_iter=10,
                 max_rescues=100, kkt="dense")

    # ---- phase 2: full-dynamics lane on the card
    tr = hanging_muscle_study(25, ignore_tendon_compliance=False,
                              ignore_activation_dynamics=False,
                              tendon_dynamics_implicit=True).transcription()
    opts = IPMOptions(max_iter=200, **bench)
    z0 = tr.initial_guess()
    Z0 = batch_guesses(tr, 32, scale=0.05, seed=0)
    res, stats = _solve_lane(torch, tr, opts, z0, Z0, dev)
    print("phase 2 full dynamics (mesh 25, B=32, f64, cuda): "
          + json.dumps(stats), flush=True)
    out["full_dynamics"] = stats

    # ---- phase 3: card against CPU, iterate level
    carries = {}
    for name in ("cuda", "cpu"):
        init_fn, body_fn, _, _ = make_kernel(tr.make_nlp(name), opts,
                                             scale_z0=z0, device=name)
        with full_precision(name):
            c = init_fn(Z0)
            for _ in range(3):
                c = body_fn(c)
        carries[name] = c
    errs = {k: _lane_rel_err(getattr(carries["cuda"], k),
                             getattr(carries["cpu"], k))
            for k in ("z", "nu", "wL", "wU")}
    same = {k: bool(torch.equal(getattr(carries["cuda"], k).cpu(),
                                getattr(carries["cpu"], k)))
            for k in ("mu", "it")}
    print("phase 3 iterate parity cuda vs cpu after 3 steps: max lane "
          f"rel err {json.dumps(errs)}, exact {json.dumps(same)}",
          flush=True)
    out["iterate_parity"] = {"max_lane_rel_err": errs, "exact": same}
    if max(errs.values()) > 1e-6 or not all(same.values()):
        _fail("phase 3: card and CPU iterates disagree")

    # ---- phase 4: card against CPU, solve level (lanes 0-3)
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
    print("phase 4 solve parity lanes 0-3: " + json.dumps(lanes), flush=True)
    out["solve_parity"] = lanes
    if not conv_cpu.any():
        _fail("phase 4: no lane converged on the CPU")
    if (conv_cpu & ~conv_gpu).any():
        _fail("phase 4: a lane converged on the CPU but not on the card")
    if (rel[conv_cpu] > 1e-2).any():
        _fail(f"phase 4: objectives differ by {rel.max():.3e} (> 1e-2)")
    if not np.isfinite(res.z.cpu().numpy()).all():
        _fail("phase 4: non-finite solution on the card")

    # ---- phase 5: simplified lane on the card
    tr_s = hanging_muscle_study(25, ignore_tendon_compliance=True,
                                ignore_activation_dynamics=True,
                                tendon_dynamics_implicit=False
                                ).transcription()
    opts_s = IPMOptions(max_iter=150, **bench)
    Z0_s = batch_guesses(tr_s, 32, scale=0.05, seed=0)
    res_s, stats_s = _solve_lane(torch, tr_s, opts_s, tr_s.initial_guess(),
                                 Z0_s, dev)
    print("phase 5 simplified (mesh 25, B=32, f64, cuda): "
          + json.dumps(stats_s), flush=True)
    out["simplified"] = stats_s
    if stats["converged"] == 0 or stats_s["converged"] == 0:
        _fail("no lane of a bench batch converged on the card")
    if not np.isfinite(res_s.z.cpu().numpy()).all():
        _fail("phase 5: non-finite solution on the card")

    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps({"kernels": []}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
