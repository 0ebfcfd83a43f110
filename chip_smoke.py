"""Drive the PyTorch port's main path once on one CUDA card.

The main path is a batched interior-point solve of the hanging-muscle
minimum-time problem (a DeGrooteFregly2016 muscle lifting a 0.5 kg mass)
through ``opensim_moco_tpu_torch.parallel.make_batched_solver``, in
float64, at the bench configuration: Hermite-Simpson at 25 mesh
intervals, 32 jittered starts, the bench's IPM options.

Phases, one report line each:

1. device: the card's name and power limit; no card, no run. Then the
   hand-written kernels are built from ``opensim_moco_tpu_torch/csrc``;
2. full-dynamics lane (activation + implicit tendon compliance),
   ``kkt="dense"``, B=8 (the first 8 of the 32 starts, so that the whole
   script stays near 10 minutes): converged, strict, mean/max iterations,
   wall seconds;
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

The line before the last lists each kernel with its launches on the main
path, its error against the plain version, and its times beside its
bound, at shape (a), and under a key that names shape (b) the same times
at shape (b), which the main path does not launch; the solve also under
a key for its 1-column times at shape (a). The last line of
standard output is the result object. Run from the root of the
repository::

    python3 chip_smoke.py [--out results.json] [--phases 8]

``--phases 8`` builds K1 and runs only its checks (about a minute): the
loop to iterate on the kernel with.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

FP64_FLOPS = 67e12  # H100 SXM, FP64 tensor core, NVIDIA data sheet
HBM_BYTES_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
ITERATE_RTOL = 1e-6
KERNEL_RTOL = 1e-10


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


def _iterate_parity(torch, tr, opts, z0, Z0):
    """init_fn + 3 body_fn steps on the card and on the CPU."""
    from opensim_moco_tpu_torch.config import full_precision
    from opensim_moco_tpu_torch.solver.ipm import make_kernel

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
    return {"max_lane_rel_err": errs, "exact": same}


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
    (kernel) and fp (plain); K is the dense KKT matrix and lu its library
    LU. Errors, KKT residuals, times, bound and barrier phases."""
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

    out = {"r": r, "max_abs_err": float((sol_k - sol_p).abs().max()),
           "max_lane_rel_err": _lane_rel_err(sol_k, sol_p),
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
    factor's, the others under ``solve_r<r>``."""
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
    at the starting points: one init_fn and one body_fn, with K1's factor
    wrapped to record its arguments."""
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
            body_fn(init_fn(Z0))
    finally:
        k1.btb_factor = real
    return seen[1]  # seen[0] is the least-squares multiplier start


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the phase results to this "
                    "JSON file")
    ap.add_argument("--phases", default="2,3,4,5,6,7,8,9",
                    help="comma-separated phases to run (default: all)")
    args = ap.parse_args()
    phases = {int(p) for p in args.phases.split(",")}

    import torch

    # ---- phase 1: device, kernel build
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this check needs a CUDA "
              "card and has no CPU fallback")
    from opensim_moco_tpu_torch.examples import hanging_muscle_study
    from opensim_moco_tpu_torch.ops import _build
    from opensim_moco_tpu_torch.ops.btb import LAUNCHES
    from opensim_moco_tpu_torch.parallel import batch_guesses
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

    bench = dict(tol=3e-3, bound_relax=1e-6, mu_init=1e-2, kappa_eps=100.0,
                 acceptable_tol_factor=30.0, acceptable_iter=10,
                 max_rescues=100)
    tr = hanging_muscle_study(25, ignore_tendon_compliance=False,
                              ignore_activation_dynamics=False,
                              tendon_dynamics_implicit=True).transcription()
    opts = IPMOptions(max_iter=200, kkt="dense", **bench)
    opts_st = dataclasses.replace(opts, kkt="structured")
    z0 = tr.initial_guess()
    Z0 = batch_guesses(tr, 32, scale=0.05, seed=0)
    res = None

    # ---- phase 2: full-dynamics lane, dense KKT
    if 2 in phases:
        res, stats = _solve_lane(torch, tr, opts, z0, Z0[:8], dev)
        print("phase 2 full dynamics, kkt=dense (mesh 25, B=8, f64, cuda): "
              + json.dumps(stats), flush=True)
        out["full_dynamics_dense"] = stats
        if stats["converged"] == 0:
            _fail("phase 2: no lane converged")

    # ---- phase 3: card against CPU, iterate level
    if 3 in phases:
        par = _iterate_parity(torch, tr, opts, z0, Z0)
        print("phase 3 iterate parity cuda vs cpu after 3 steps, kkt=dense: "
              + json.dumps(par), flush=True)
        out["iterate_parity_dense"] = par
        if max(par["max_lane_rel_err"].values()) > ITERATE_RTOL or \
                not all(par["exact"].values()):
            _fail("phase 3: card and CPU iterates disagree")

    # ---- phase 4: card against CPU, solve level (lanes 0-3)
    if 4 in phases and res is not None:
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
        tr_s = hanging_muscle_study(25, ignore_tendon_compliance=True,
                                    ignore_activation_dynamics=True,
                                    tendon_dynamics_implicit=False
                                    ).transcription()
        opts_s = IPMOptions(max_iter=150, kkt="dense", **bench)
        Z0_s = batch_guesses(tr_s, 8, scale=0.05, seed=0)
        _, stats_s = _solve_lane(torch, tr_s, opts_s, tr_s.initial_guess(),
                                 Z0_s, dev)
        print("phase 5 simplified, kkt=dense (mesh 25, B=8, f64, cuda): "
              + json.dumps(stats_s), flush=True)
        out["simplified_dense"] = stats_s
        if stats_s["converged"] == 0:
            _fail("phase 5: no lane converged")

    # ---- phase 6: full-dynamics lane, kkt="auto" (the JAX bench's mode)
    launches = {}
    if 6 in phases:
        _, stats6 = _solve_lane(torch, tr, dataclasses.replace(
            opts, kkt="auto"), z0, Z0, dev, LAUNCHES)
        print("phase 6 full dynamics, kkt=auto (mesh 25, B=32, f64, cuda): "
              + json.dumps(stats6), flush=True)
        out["full_dynamics_auto"] = stats6
        if stats6["converged"] == 0:
            _fail("phase 6: no lane converged")
        if stats6["launches"]["btb_factor"] == 0 or \
                stats6["launches"]["btb_solve"] == 0:
            _fail("phase 6: the least-squares start did not go through K1")

    # ---- phase 7: full-dynamics lane, kkt="structured" (K1 throughout)
    if 7 in phases:
        res7, stats7 = _solve_lane(torch, tr, opts_st, z0, Z0, dev,
                                   LAUNCHES)
        launches = stats7["launches"]
        print("phase 7 full dynamics, kkt=structured (mesh 25, B=32, f64, "
              "cuda): " + json.dumps(stats7), flush=True)
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
        blocks = _capture_first_newton_blocks(torch, tr, opts_st, z0, Z0)
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
        par = _iterate_parity(torch, tr, opts_st, z0, Z0)
        print("phase 9 iterate parity cuda vs cpu after 3 steps, "
              "kkt=structured: " + json.dumps(par), flush=True)
        out["iterate_parity_structured"] = par
        if max(par["max_lane_rel_err"].values()) > ITERATE_RTOL or \
                not all(par["exact"].values()):
            _fail("phase 9: card and CPU iterates disagree")

    if args.out:
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
