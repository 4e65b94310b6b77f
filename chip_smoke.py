#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (mrcal_tpu_torch).

Run from the root of the repository on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port only (no JAX) through these phases; any failure exits
nonzero:

1. device: a CUDA card is required; prints nvidia-smi's name and power
   limit of the card.
2. build: compiles the batched-Cholesky kernels from the checkout's
   sources and prints nvcc's -Xptxas -v report.
3. kernels: each kernel against its plain PyTorch version on the card:
   the factor-then-solve checks (f64 and f32, n=6 and n=3, a ragged
   batch, a non-SPD block, a cond-1e6 f32 batch), then the fused
   cholesky_factor_solve and the solve at the Schur step's shapes
   (opencv8_1cam, opencv8_4cam, rig16cam, splined_30x18's K = 1083), a
   ragged B, K past a warp, B = 0 and a large-B sweep, f64 and f32.
4. main path: the bench's opencv8_1cam calibration (LENSMODEL_OPENCV8, one
   camera, 84 frames of a 14x14 board; 32938 measurements, 518 states),
   perturbed as bench._perturbed_oi(seed=1), solved by optimize() on the
   card in f64 (warm-up, then timed, with the kernels' launch counts: one
   cholesky_factor_solve and one cholesky_solve_factored per iteration)
   and in mixed precision.  The converged rms is held to the JAX
   package's f64 result, 0.2958451838 px, in 32 +- 3 iterations.
5. rig16cam: the bench's widest block solve (16 cameras, 40 frames;
   251040 measurements, 524 states; the frame blocks are solved against
   K = 285 columns), warm-up, then a timed f64 solve held to the JAX
   package's f64 rms, 0.2990332534 px.
   sfm_triangulated: the bench's triangulated-point SfM (8 PINHOLE
   cameras, 492 points seen in 3527 observations; 11443 measurements, 42
   states: the extrinsics only), warm-up, then a timed f64 solve held to
   the JAX package's f64 rms, 0.00014919536101374561 px (relative 1e-6),
   in 6 +- 3 iterations (the port's own count; the JAX package takes 14,
   see PERF.md).  The points are not state, so no batched-Cholesky kernel
   may launch.
   opencv8_4cam: the bench's four-camera board calibration (84 frames;
   131752 measurements, 572 states; the frame blocks are solved against
   K = 69 columns), warm-up, then a timed f64 solve held to the JAX
   package's f64 rms, 0.29864967030878176 px +- 1e-6, in 32 +- 3
   iterations, one launch of each path kernel per iteration.
   splined_30x18: the bench's splined model
   (LENSMODEL_SPLINED_STEREOGRAPHIC_order=3_Nx=30_Ny=18_fov_x_deg=150,
   core locked; 84 frames; 34008 measurements, 1586 states; the frame
   blocks are solved against K = 1083 columns), through the spline-window
   normal equations: warm-up, then a timed f64 solve held to the JAX
   package's f64 rms, 0.2878366388388636 px +- 1e-6, in 80 +- 5
   iterations, one launch of each path kernel per iteration; a mixed
   solve (its f32 phase with the lazy Hessian, K = 4) held to +- 1e-5;
   and the mixed pipeline with the float32-H polish (its f64 phase
   assembles H in float32 under the float64 gradient) held to +- 1e-6.
   optimizer_callback: on the card and on the CPU for sfm_triangulated,
   opencv8_1cam and splined_30x18 (each board row: its 32 window entries,
   its frame and the warp); the sparse Jacobians' shapes and stored
   entries agree, and x and J agree to 1e-12 of their largest entry.
   Then optimize(check_gradient=True) on a small board problem and on a
   small splined one, card against CPU.
   triangulate: the six two-view wrappers (with their gradients), the
   pose functions (rotate_point_R; R_from_r, rotate_point_r and
   transform_point_rt with their gradients; compose_r and compose_rt
   three-way, with gradients and inverted0/inverted1) and unproject_core
   (PINHOLE, OPENCV8) on the card, the wrappers' default device, against
   the CPU, to 1e-12.
   uncertainty: converged f64 solves of opencv8_1cam (Nstate 518),
   opencv8_4cam and splined_30x18 (Nstate 1586) become cameramodels;
   projection_uncertainty on the 30 x 22 grid of
   mrcal-show-projection-uncertainty (unit vectors, at 1 m and at
   infinity): every method, covariance and worstdirection-stdev, on
   opencv8_1cam; mean-pcam and ccp on opencv8_4cam's camera 2 and on
   splined_30x18.  Then opencv8_1cam on its odd-numbered 42 frames (the
   fused kernel at (42, 6, 15)), and projection_diff with uncertainties
   between the two models at infinity and at 1 m.  Each call is held to
   the same call on the CPU (UNC_* and DIFF_* tolerances) and prints its
   warm wall time on the card, split into J, factor, F's Jacobian and
   propagation, beside the CPU's.
6. mesh: the multi-device path (mrcal_tpu_torch.parallel), the
   observations sharded over a torch.distributed group.
   nccl1: a one-rank NCCL group (a file store in a temporary directory,
   loopback only); opencv8_1cam by optimize(mesh=1) in f64, held to the
   main path's rms and iteration gates and to the unsharded optimize()'s
   E (sum x^2) at MESH_E_RTOL, one fused launch at (84, 6, 15) and one
   back-substitution at (84, 6, 1) per iteration; its ms per iteration
   against the unsharded solve's, timed in turns (unsharded, mesh, mesh,
   unsharded); the all-reduce calls per normal-equation evaluation, and
   the bytes held equal to collective_bytes_per_iteration; mixed through
   the mesh (the main path's mixed gate); then splined_30x18 on the same
   mesh in f64 (its rms and iteration gates, the fused solve at K = 1083,
   its bytes held to collective_bytes_per_iteration).
   gloo2: two processes share the one card over gloo (NCCL takes one rank
   per card); opencv8_1cam by optimize(mesh=2) in f64 on each, held to
   the unsharded E at MESH_E_RTOL and b_packed at MESH_B_ATOL (the
   update threshold), with b bit-identical on both ranks; then
   dryrun_multichip(2) (two ranks sharing the card over gloo: 3
   iterations of an OPENCV8 and a 9x7-knot splined problem).
7. batch: optimize_batch runs many problems of one structure in
   lockstep, in f64 (a short warm-up, then a timed solve with the
   kernels' launch counts and shapes and the peak memory):
   fleet: 64 units of opencv8_1cam (unit 0 the main path's problem;
   unit i >= 1 perturbed_oi(seed=1+i) with 0.2 px noise on its board
   x, y; units 48-63 each miss two views, so the fleet goes through
   pad_problems_to_common_structure).  Unit 0 is held to the main path's
   rms and iteration gates; one fused launch at (5376, 6, 15) and one
   back-substitution at (5376, 6, 1) per lockstep iteration; batches of
   1 and 8 units timed, the batch of 1 held to optimize()'s E at 1e-12.
   Then the fleet again, run to the end of its tails (ftol = 1e-10, see
   DEEP_KW):
   units 0, 1, 48 and 63 (the last two without their missing views) are
   solved alone by optimize() and held to their batch results (E = sum
   x^2 to 1e-9 relative, b_packed to 1e-5).  A mixed batch: unit 0 held
   to the main path's mixed gate, and every unit's difference from its
   f64 rms printed (PERF.md: where the flat units stop differs by up to
   3.5e-5 px between the two pipelines).
   rig16cam x 8: unit 0 held to the rig16cam gate; (320, 6, 285) and
   (320, 6, 1), one launch each per lockstep iteration.
   sfm_triangulated x 4: unit 0 held to the sfm_triangulated rms, ending
   on the small-step rule (SFM_BATCH_NITER_RANGE); no batched-Cholesky
   launch.
   Each prints its wall, lockstep and per-unit iterations, problems per
   second, ms per lockstep iteration, the peak memory and P times the
   single solve's wall.
8. kernel times: each kernel at the shapes of phase 3 in f64 (CUDA
   events, and device time per launch from torch.profiler) beside its
   plain version, the PyTorch library call and its bound, and beside the
   launch floor (a one-element torch.add).
9. profile: one more f64 solve of each configuration, and of the fleet,
   under torch.profiler (device time by kernel, launches per iteration,
   busy share).
10. the last line: {"ok": true, "device": {...}}.

The timed solves come before any profiler session or kernel timing, so
that those do not weigh on the solves' wall time.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# the JAX package's converged rms on this problem (f64, CPU backend)
F64_RMS = 0.2958451838
F64_RMS_TOL = 1e-6
F64_NITER_RANGE = (32 - 3, 32 + 3)    # the JAX package's count, 32
MIXED_RMS_TOL = 1e-5
# rig16cam: the JAX package's converged f64 rms on the CPU (64 iterations):
# JAX_PLATFORMS=cpu python -c "import bench, mrcal_tpu; ..." (PERF.md)
RIG16_F64_RMS = 0.2990332534279465
RIG16_F64_RMS_TOL = 1e-6
# sfm_triangulated and opencv8_4cam: the JAX package's converged f64 rms
# and iterations on the CPU (PERF.md section 2 gives the command)
SFM_F64_RMS = 0.00014919536101374561
SFM_F64_RMS_REL_TOL = 1e-6
# the port's own count: 6 on the CPU at 1-8 threads and on the card
# (PERF.md).  The JAX package takes 14: its small-angle measurement
# cancels, so its stopping point follows roundoff (ROADMAP, standing
# deviations)
SFM_NITER_RANGE = (6 - 3, 6 + 3)
CAM4_F64_RMS = 0.29864967030878176
CAM4_F64_RMS_TOL = 1e-6
CAM4_NITER_RANGE = (32 - 3, 32 + 3)
# splined_30x18: the JAX package's converged f64 rms and iterations on the
# CPU (PERF.md section 2 gives the command)
SPLINED_F64_RMS = 0.2878366388388636
SPLINED_F64_RMS_TOL = 1e-6
SPLINED_NITER_RANGE = (80 - 5, 80 + 5)
SPLINED_MIXED_RMS_TOL = 1e-5
SPLINED_H32_RMS_TOL = 1e-6
# optimizer_callback on the card against the CPU: x and J to this much of
# their largest entry
CALLBACK_REL_TOL = 1e-12
# check_gradient's worst relative error, card against CPU: the finite
# differences' roundoff, eps |x| / FD_STEP, is ~2e-11 of a pixel here
CHECK_GRADIENT_ABS_TOL = 1e-10
# the two-view wrappers, rotate_point_R and unproject_core on the card
# against the CPU, to this much of each output's largest entry
TRIANGULATE_REL_TOL = 1e-12

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, and the
# non-tensor-core FP64 / FP32 rates
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float64": 34e12, "float32": 67e12}
KERNEL_REPLACES = "mrcal_tpu/ops/batched_cholesky.py:118"
KERNEL_SOURCE = "mrcal_tpu_torch/csrc/batched_cholesky.cu"
# the kernels' wrappers, as named in the kernels line and the launch counts
LAUNCHED = ("cholesky_factor_solve", "cholesky_solve_factored",
            "cholesky_factor")
SOLVE_KW = dict(update_threshold=1e-7, max_iterations=2000)
# the batch phases: the fleet's size, its units that miss two views each,
# and the board noise of units i >= 1 (px)
FLEET_P = 64
FLEET_DROPPED_FROM = 48
FLEET_NOISE_PX = 0.2
FLEET_CHECKED_UNITS = (0, 1, 48, 63)
RIG16_BATCH_P = 8
SFM_BATCH_P = 4
# a unit's batch result against its own optimize(): E = sum x^2 relative,
# b_packed absolute (packed units); a batch of one against optimize()
BATCH_E_RTOL = 1e-9
BATCH_B_ATOL = 1e-5
BATCH_P1_E_RTOL = 1e-12
# A unit's batch and single solves are held against each other at the
# end of their tails.  Under the default ftol (1e-6) many fleet units end
# on the 16-iteration plateau rule inside a linearly converging tail
# (lambda at its 1e-11 floor, E falling ~13 % per iteration), up to 6.6e-6
# in E above the tail's end, and where they stop follows roundoff: unit 63
# alone and in the batch stopped 6.9e-9 apart in E on the card.  ftol =
# 1e-10 ends a tail within ~1e-10 of its end, while E's evaluation noise
# (~1e-13 relative) stays far below the window's threshold; ftol = 0 lets
# a unit grind on that noise (1889 iterations on the card).  PERF.md §6.
DEEP_KW = dict(SOLVE_KW, ftol=1e-10)
# sfm_triangulated x 4: the last steps' predicted decrease (~3e-23) is
# far below E's evaluation noise (~2e-18), so accepting them is a coin
# flip and the count after the last large step follows roundoff (alone,
# units 0-3 take 6, 8, 15 and 14 iterations; in the batch 11, 6, 6, 9):
# unit 0 is held to ending on the small-step rule, before the first
# plateau window closes
SFM_BATCH_NITER_RANGE = (SFM_NITER_RANGE[0], 15)
# the mesh phases against the unsharded solve: E = sum x^2 relative, and
# (two ranks) b_packed absolute, in packed units.  Two ranks sum the
# normal equations in another order, and the converged b is resolved only
# to the solve's update threshold: on the card the two-rank opencv8_1cam
# solve took the unsharded 32 iterations and ended 2.0e-8 from its b, E
# 7.1e-11 relative apart (PERF.md)
MESH_E_RTOL = 1e-10
MESH_B_ATOL = SOLVE_KW["update_threshold"]
# the uncertainty phase: the grid of mrcal-show-projection-uncertainty
# (30 wide; 30 x 22 on the 800 x 600 imager), and the card against the
# CPU: covariances to this much of their largest entry, stdev grids
# relative, projection_diff's difflen (px) and Rt10.  The bench problems
# hold corners seen at steep angles whose rows dominate J and are
# evaluated with cancellation: the card's and the CPU's J differ by up
# to 2e-11 relative per entry (1.6e-14 of the largest), which moves the
# covariances by 3e-9-8e-9 (opencv8_1cam), 1e-9 (opencv8_4cam) and
# 2.5e-8-7.4e-8 (splined_30x18) of their largest entry; a 1-ulp random
# perturbation of J moves opencv8_1cam's by as much, 2.6e-9
# (uncertainty_conditioning; PERF.md)
UNC_GRID = 30
UNC_COV_TOL = 1e-7
UNC_STDEV_RTOL = 1e-7
DIFF_DIFFLEN_TOL = 1e-8
DIFF_RT10_TOL = 1e-9
UNC_METHODS = ("mean-pcam", "cross-reprojection-rrp-Jfp",
               "cross-reprojection-ccp")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def rel_err(a, b):
    if not b.numel():
        return 0.0
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def spd_batch(rng, B, n, K):
    M = rng.normal(size=(B, n, n))
    A = np.einsum("bij,bkj->bik", M, M) + n * np.eye(n)
    return A, rng.normal(size=(B, n, K))


def time_ms(torch, fn, reps=200, warmup=20):
    """Mean device time of fn() over reps calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_us(torch, fn, name, reps=20):
    """Device time per launch (us) of the kernels whose profiler key holds
    name + "<" (None: every kernel), over reps calls of fn.  A session
    that saw none of them is taken again, twice at most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        sel = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and (name is None or name + "<" in e.key)]
        n = sum(e.count for e in sel)
        if n:
            return sum(e.self_device_time_total for e in sel) / n
    return None


def phase_device(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}, {torch.cuda.device_count()} card(s), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return name, smi


def phase_build():
    from mrcal_tpu_torch.ops import _build, batched_cholesky as bc
    built = _build.load("batched_cholesky")
    bc.kernel_library()
    log(f"[build] {os.path.relpath(built.path, ROOT)} in "
        f"{built.seconds:.2f} s; nvcc -Xptxas -v:")
    for line in built.log.strip().splitlines():
        log(f"[build]   {line}")
    return built


def phase_kernels(torch):
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}

    for dt in (torch.float64, torch.float32):
        for B, n, K in [(84, 6, 14), (84, 6, 1), (500, 3, 4), (1000, 6, 3),
                        (1000, 3, 1)]:
            A_np, rhs_np = spd_batch(rng, B, n, K)
            A = torch.as_tensor(A_np, dtype=dt, device=dev)
            rhs = torch.as_tensor(rhs_np, dtype=dt, device=dev)
            L_k = bc.cholesky_factor(A)
            L_p = bc.cholesky_factor_plain(A)
            x_k = bc.cholesky_solve_factored(L_p, rhs)
            x_p = bc.cholesky_solve_factored_plain(L_p, rhs)
            torch.cuda.synchronize()
            e_L, e_x = rel_err(L_k, L_p), rel_err(x_k, x_p)
            log(f"[kernels] {str(dt)[6:]} B={B} n={n} K={K}: factor rel "
                f"err {e_L:.3e}, solve rel err {e_x:.3e} (tol {tol[dt]:g})")
            if not (e_L <= tol[dt] and e_x <= tol[dt]):
                fail(f"kernel disagrees with the plain version at "
                     f"{dt} B={B} n={n} K={K}")

    # a non-SPD block: NaN there, finite elsewhere, in both versions
    for dt in (torch.float64, torch.float32):
        A_np, rhs_np = spd_batch(rng, 84, 6, 14)
        A_np[5] = -A_np[5]
        A = torch.as_tensor(A_np, dtype=dt, device=dev)
        rhs = torch.as_tensor(rhs_np, dtype=dt, device=dev)
        for label, x in (("kernel", bc.batched_cholesky_solve(A, rhs)),
                         ("plain", bc.cholesky_solve_factored_plain(
                             bc.cholesky_factor_plain(A), rhs))):
            ok = torch.cat([x[:5], x[6:]])
            if not (torch.isnan(x[5]).all() and torch.isfinite(ok).all()):
                fail(f"non-SPD block: {label} {dt} does not give NaN in "
                     "that block alone")
    log("[kernels] non-SPD block -> NaN in that block only (kernel and "
        "plain, f64 and f32)")

    # cond 1e6 in f32 (tests/test_ops.py's case): finite, f32-accurate
    n, K, B = 6, 7, 64
    U = np.linalg.qr(rng.normal(size=(B, n, n)))[0]
    eig = np.stack([np.logspace(0, -6, n)] * B)
    A_np = (U * eig[:, None, :]) @ U.transpose(0, 2, 1)
    rhs_np = rng.normal(size=(B, n, K))
    x_ref = np.linalg.solve(A_np, rhs_np)
    A = torch.as_tensor(A_np, dtype=torch.float32, device=dev)
    rhs = torch.as_tensor(rhs_np, dtype=torch.float32, device=dev)
    for label, x in (("kernel", bc.batched_cholesky_solve(A, rhs)),
                     ("plain", bc.cholesky_solve_factored_plain(
                         bc.cholesky_factor_plain(A), rhs))):
        x = x.double().cpu().numpy()
        rel = np.abs(x - x_ref).max() / np.abs(x_ref).max()
        log(f"[kernels] cond 1e6 f32 {label}: rel err vs f64 {rel:.3e} "
            "(tol 0.1)")
        if not (np.isfinite(x).all() and rel < 0.1):
            fail(f"cond-1e6 f32 case: {label} rel err {rel}")

    check_fused(torch, rng)


# (B, n, K) where the fused kernel and the solve are held to their plain
# versions: the Schur step's shapes on opencv8_1cam (K = Nc + 1 = 15, and
# 1 for the back-substitution) and rig16cam (K = 16*12 + 15*6 + 2 + 1 =
# 285), a ragged B with K past a warp, B = 0, and the large-B sweep (K = 0
# is the fused entry with no right-hand side)
MAIN_SHAPES = [(84, 6, 15), (84, 6, 1)]
CAM4_SHAPES = [(84, 6, 69)]                  # K = 4*12 + 3*6 + 2 + 1
RIG16_SHAPES = [(40, 6, 285), (40, 6, 1)]
SPLINED_SHAPES = [(84, 6, 1083)]             # K = 2*30*18 + 2 + 1
# the uncertainty phase's solve of opencv8_1cam's odd-numbered frames
ODD_SHAPES = [(42, 6, 15), (42, 6, 1)]
# the batched Schur step: every problem's frame blocks in one launch
FLEET_SHAPES = [(FLEET_P * 84, 6, 15), (FLEET_P * 84, 6, 1)]
RIG16_BATCH_SHAPES = [(RIG16_BATCH_P * 40, 6, 285),
                      (RIG16_BATCH_P * 40, 6, 1)]
LARGE_SHAPES = [(1 << 20, 3, 4), (1 << 18, 6, 15), (1 << 20, 3, 1),
                (1 << 18, 6, 1)]
CHECK_SHAPES = (MAIN_SHAPES + CAM4_SHAPES + RIG16_SHAPES + SPLINED_SHAPES
                + ODD_SHAPES + FLEET_SHAPES + RIG16_BATCH_SHAPES
                + [(131, 6, 33), (131, 3, 4), (0, 6, 15), (70000, 6, 0)]
                + LARGE_SHAPES)


def check_fused(torch, rng):
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    dev = torch.device("cuda")
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    for dt in (torch.float64, torch.float32):
        for B, n, K in CHECK_SHAPES:
            A_np, rhs_np = spd_batch(rng, B, n, K)
            A = torch.as_tensor(A_np, dtype=dt, device=dev)
            rhs = torch.as_tensor(rhs_np, dtype=dt, device=dev)
            L_p, x_p = bc.cholesky_factor_solve_plain(A, rhs)
            L_k, x_k = bc.cholesky_factor_solve(A, rhs)
            x_s = bc.cholesky_solve_factored(L_p, rhs)
            torch.cuda.synchronize()
            if L_k.shape != (B, n, n) or x_k.shape != (B, n, K):
                fail(f"fused kernel: wrong output shape at {(B, n, K)}")
            errs = ([rel_err(L_k, L_p), rel_err(x_k, x_p), rel_err(x_s, x_p)]
                    if B else [0.0, 0.0, 0.0])
            log(f"[kernels] {str(dt)[6:]} B={B} n={n} K={K}: fused L rel "
                f"err {errs[0]:.3e}, x {errs[1]:.3e}; solve x "
                f"{errs[2]:.3e} (tol {tol[dt]:g})")
            if not all(e <= tol[dt] for e in errs):
                fail(f"fused or solve kernel disagrees with the plain "
                     f"version at {dt} B={B} n={n} K={K}")

    # a non-SPD block, among few and many: non-finite there, finite
    # elsewhere
    for dt in (torch.float64, torch.float32):
        for B, K in ((84, 15), (70000, 1)):
            A_np, rhs_np = spd_batch(rng, B, 6, K)
            A_np[5] = -A_np[5]
            A = torch.as_tensor(A_np, dtype=dt, device=dev)
            rhs = torch.as_tensor(rhs_np, dtype=dt, device=dev)
            for label, x in (
                    ("fused", bc.cholesky_factor_solve(A, rhs)[1]),
                    ("solve", bc.cholesky_solve_factored(
                        bc.cholesky_factor(A), rhs))):
                ok = torch.cat([x[:5], x[6:]])
                if torch.isfinite(x[5]).any() or \
                        not torch.isfinite(ok).all():
                    fail(f"non-SPD block: {label} {dt} B={B} is not "
                         "non-finite in that block alone")
    log("[kernels] non-SPD block -> non-finite in that block only (fused "
        "and factor+solve kernels, B = 84 and 70000, f64 and f32)")


def _bound(B, n, K, elt, wrapper):
    """Least time (ms) for a wrapper's work on the card, and its limit."""
    ops_f = B * (sum(i * (i + 1) for i in range(n)) + n * (n + 1) // 2)
    ops_s = B * K * 2 * n * n
    nbytes, nops = dict(
        cholesky_factor=(2 * B * n * n, ops_f),
        cholesky_solve_factored=(B * n * n + 2 * B * n * K, ops_s),
        cholesky_factor_solve=(2 * B * n * n + 2 * B * n * K,
                               ops_f + ops_s))[wrapper]
    nbytes *= elt
    t_b = nbytes / PEAK_BYTES_PER_S * 1e3
    t_o = nops / PEAK_OPS_PER_S["float64" if elt == 8 else "float32"] * 1e3
    return max(t_b, t_o), ("bytes" if t_b >= t_o else "operations"), nbytes


def time_kernels(torch, card):
    """Each wrapper at its shapes, f64: CUDA-event ms per call, device us
    per launch, plain and library ms, bound and share; and the launch
    floor."""
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    dt = torch.float64

    x1 = torch.zeros(1, dtype=dt, device=dev)
    floor_ms = time_ms(torch, lambda: torch.add(x1, x1))
    floor_us = device_us(torch, lambda: torch.add(x1, x1), None)
    log(f"[kernels] launch floor (one-element torch.add, f64): "
        f"{floor_ms:.4f} ms per call (CUDA events), {floor_us:.3f} us "
        "device time per launch (profiler)")

    shapes = dict(
        cholesky_factor_solve=(MAIN_SHAPES + CAM4_SHAPES + RIG16_SHAPES
                               + SPLINED_SHAPES + ODD_SHAPES[:1]
                               + FLEET_SHAPES + RIG16_BATCH_SHAPES
                               + LARGE_SHAPES),
        cholesky_solve_factored=(MAIN_SHAPES + CAM4_SHAPES + RIG16_SHAPES
                                 + ODD_SHAPES[1:] + FLEET_SHAPES
                                 + RIG16_BATCH_SHAPES + LARGE_SHAPES),
        cholesky_factor=[(84, 6, 0), (1 << 20, 3, 0), (1 << 18, 6, 0)])
    results = {name: [] for name in shapes}
    for name, todo in shapes.items():
        for B, n, K in todo:
            A_np, rhs_np = spd_batch(rng, B, n, max(K, 1))
            A = torch.as_tensor(A_np, dtype=dt, device=dev)
            rhs = torch.as_tensor(rhs_np[..., :K], dtype=dt, device=dev)
            L = torch.linalg.cholesky(A).contiguous()
            kernel, plain, library = dict(
                cholesky_factor_solve=(
                    lambda: bc.cholesky_factor_solve(A, rhs),
                    lambda: bc.cholesky_factor_solve_plain(A, rhs),
                    lambda: torch.cholesky_solve(
                        rhs, torch.linalg.cholesky(A))),
                cholesky_solve_factored=(
                    lambda: bc.cholesky_solve_factored(L, rhs),
                    lambda: bc.cholesky_solve_factored_plain(L, rhs),
                    lambda: torch.cholesky_solve(rhs, L)),
                cholesky_factor=(
                    lambda: bc.cholesky_factor(A),
                    lambda: bc.cholesky_factor_plain(A),
                    lambda: torch.linalg.cholesky(A)))[name]
            out_k = kernel()
            out_p = plain()
            if name == "cholesky_factor_solve":
                out_k, out_p = out_k[1], out_p[1]
            err = float((out_k - out_p).abs().max())
            large = B > 10000
            reps, warm = (10, 3) if large else (200, 20)
            k_ms = time_ms(torch, kernel, reps, warm)
            p_ms = time_ms(torch, plain, reps, warm)
            l_ms = time_ms(torch, library, reps, warm)
            us = device_us(torch, kernel, name + "_kernel",
                           reps=5 if large else 20)
            b_ms, b_by, nbytes = _bound(B, n, K, A.element_size(), name)
            r = dict(shape=[B, n, K], ms=k_ms,
                     device_us_per_launch=us, plain_ms=p_ms, library_ms=l_ms,
                     bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                     share_of_bound_events=b_ms / k_ms,
                     share_of_bound_device=(b_ms * 1e3 / us) if us else None,
                     max_abs_err=err)
            results[name].append(r)
            log(f"[kernels] {name} {(B, n, K)} f64: kernel "
                f"{k_ms:.4f} ms/call, {us or float('nan'):.3f} us/launch "
                "on the device; "
                f"plain {p_ms:.4f} ms, library {l_ms:.4f} ms; bound "
                f"{b_ms * 1e3:.4f} us ({b_by}, {nbytes} B), share "
                f"{r['share_of_bound_events'] * 100:.2f} % (events) / "
                f"{(r['share_of_bound_device'] or 0) * 100:.2f} % (device); "
                f"max abs err {err:.3e}")
            del A, rhs, L
            torch.cuda.empty_cache()

    entries = []
    for name, res in results.items():
        main = res[0]
        entries.append(dict(
            name=name, route="cuda", source=KERNEL_SOURCE,
            replaces=KERNEL_REPLACES, launches=None,
            max_abs_err=main["max_abs_err"], ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
            device_us_per_launch=main["device_us_per_launch"],
            shape=main["shape"], dtype="float64", card=card,
            on_main_path=name != "cholesky_factor", shapes=res))
    return entries, dict(ms=floor_ms, device_us_per_launch=floor_us)


def _copy(oi):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v)
            for k, v in oi.items()}


def phase_main_path(torch):
    from mrcal_tpu_torch import optimize, problems

    # small input first: the card's solve against the CPU's
    oi_small = problems.make_problem(device="cpu")[0]
    s_gpu = optimize(**_copy(oi_small))
    s_cpu = optimize(device="cpu", **_copy(oi_small))
    d = abs(s_gpu["rms_reproj_error__pixels"]
            - s_cpu["rms_reproj_error__pixels"])
    log(f"[main] small problem: rms card {s_gpu['rms_reproj_error__pixels']!r}"
        f" vs cpu {s_cpu['rms_reproj_error__pixels']!r} "
        f"({s_gpu['niterations']} / {s_cpu['niterations']} iterations)")
    if not d <= 1e-10 * s_cpu["rms_reproj_error__pixels"]:
        fail(f"small problem: card and CPU rms differ by {d}")

    oi, f64 = timed_solve(
        torch, "main", problems.perturbed_oi(problems.opencv8_1cam(), seed=1),
        (32938, 518), F64_RMS, F64_RMS_TOL, F64_NITER_RANGE)

    oi_mx = _copy(oi)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats_mx = optimize(precision="mixed", **SOLVE_KW, **oi_mx)
    torch.cuda.synchronize()
    wall_mx = time.perf_counter() - t0
    rms_mx = stats_mx["rms_reproj_error__pixels"]
    n_pol = stats_mx["niterations_polish"]
    n_f32 = stats_mx["niterations"] - n_pol
    log(f"[main] mixed: rms {rms_mx!r} px, {n_f32} f32 + {n_pol} f64 "
        f"iterations, {wall_mx:.4f} s wall, "
        f"{wall_mx / max(stats_mx['niterations'], 1) * 1e3:.3f} "
        f"ms/iteration, phases {stats_mx['time_s']}")
    if not abs(rms_mx - F64_RMS) <= MIXED_RMS_TOL:
        fail(f"mixed rms {rms_mx} is not within {MIXED_RMS_TOL} of "
             f"{F64_RMS}")
    return oi, dict(f64=f64,
                    mixed=dict(rms=rms_mx, niterations_f32=n_f32,
                               niterations_polish=n_pol, wall_s=wall_mx))


def check_launches_per_iteration(phase, launches, niter):
    """The Schur step launches the fused kernel and the solve once per
    iteration each, and the factor alone never."""
    for name, want in (("cholesky_factor_solve", niter),
                       ("cholesky_solve_factored", niter),
                       ("cholesky_factor", 0)):
        if launches[name] != want:
            fail(f"[{phase}] {name} launched {launches[name]} times in "
                 f"{niter} iterations; expected {want}")


def time_halves(torch, phase, oi_solved, stats):
    """One iteration's two halves, timed apart on the solved state."""
    from mrcal_tpu_torch.convert import from_reference
    from mrcal_tpu_torch.optimize.solver import (build_normal_equations,
                                                 schur_step)
    spec_t, arrays, b = from_reference(oi_solved, stats["b_packed"],
                                       device="cuda")
    static_idx = {
        key: (np.zeros((0, 3), np.int64) if oi_solved.get(name) is None
              else oi_solved[name])
        for key, name in (
            ("board", "indices_frame_camintrinsics_camextrinsics"),
            ("point", "indices_point_camintrinsics_camextrinsics"))}
    ne_fn = build_normal_equations(spec_t, arrays, static_idx)
    out = {}
    with torch.no_grad():
        ne = ne_fn(b, arrays)
        out["fused_K"] = ne["Cf"].shape[-1] + 1
        lam = torch.full((), 1e-4, dtype=b.dtype, device=b.device)
        for label, fn in (("normal_equations", lambda: ne_fn(b, arrays)),
                          ("schur_step", lambda: schur_step(ne, lam,
                                                            spec_t))):
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            out[label + "_ms"] = (time.perf_counter() - t0) / 20 * 1e3
            log(f"[{phase}] f64 {label.replace('_', ' ')}: "
                f"{out[label + '_ms']:.3f} ms per call")
    return out


def timed_solve(torch, phase, oi, shape, rms_ref, rms_tol, niter_range=None,
                launches_per_iteration=True):
    """A bench configuration in f64: a warm-up solve, then a timed solve
    with the kernels' launch counts, held to the JAX package's rms (and
    iteration count), and its two halves timed apart."""
    from mrcal_tpu_torch import optimize
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    from mrcal_tpu_torch.optimize import spec_from_inputs

    spec = spec_from_inputs(**oi)
    log(f"[{phase}] Nmeasurements {spec.Nmeasurements}, Nstate "
        f"{spec.Nstate}")
    if (spec.Nmeasurements, spec.Nstate) != shape:
        fail(f"{phase} has the wrong shape")
    t0 = time.perf_counter()
    optimize(precision="f64", **SOLVE_KW, **_copy(oi))
    torch.cuda.synchronize()
    log(f"[{phase}] f64 warm-up solve {time.perf_counter() - t0:.3f} s")

    oi_f64 = _copy(oi)
    torch.cuda.synchronize()
    bc.reset_launches()
    t0 = time.perf_counter()
    stats = optimize(precision="f64", **SOLVE_KW, **oi_f64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(bc.launches)
    rms = stats["rms_reproj_error__pixels"]
    niter = stats["niterations"]
    log(f"[{phase}] f64: rms {rms!r} px in {niter} iterations, "
        f"{wall:.4f} s wall, {wall / niter * 1e3:.3f} ms/iteration, "
        f"launches {launches}, phases {stats['time_s']}")
    if not (np.isfinite(stats["x"]).all()
            and stats["x"].shape == (spec.Nmeasurements,)
            and np.isfinite(oi_f64["intrinsics"]).all()):
        fail(f"{phase} f64 solve: non-finite or misshapen output")
    if not abs(rms - rms_ref) <= rms_tol:
        fail(f"{phase} f64 rms {rms!r} is not within {rms_tol} of "
             f"{rms_ref!r}")
    if niter_range is not None and \
            not niter_range[0] <= niter <= niter_range[1]:
        fail(f"{phase} f64 solve took {niter} iterations, not "
             f"{niter_range[0]}-{niter_range[1]}")
    if launches_per_iteration:
        check_launches_per_iteration(phase, launches, niter)
    elif any(launches.values()):
        fail(f"[{phase}] launched batched-Cholesky kernels {launches}; "
             "this path has no frame or point blocks")
    halves = time_halves(torch, phase, oi_f64, stats)
    return oi, dict(rms=rms, niterations=niter, wall_s=wall,
                    ms_per_iteration=wall / niter * 1e3, launches=launches,
                    **halves)


def phase_rig16cam(torch):
    """rig16cam in f64: the frame blocks' solve at K = 285."""
    from mrcal_tpu_torch import problems
    return timed_solve(torch, "rig16cam",
                       problems.perturbed_oi(problems.rig16cam(), seed=1),
                       (251040, 524), RIG16_F64_RMS, RIG16_F64_RMS_TOL)


def phase_sfm(torch):
    """sfm_triangulated in f64: the triangulated pairs' rows, the dense
    42x42 reduced system, and no block kernel."""
    from mrcal_tpu_torch import problems
    return timed_solve(
        torch, "sfm_triangulated",
        problems.perturbed_oi(problems.sfm_triangulated(), seed=1),
        (11443, 42), SFM_F64_RMS, SFM_F64_RMS * SFM_F64_RMS_REL_TOL,
        SFM_NITER_RANGE, launches_per_iteration=False)


def phase_4cam(torch):
    """opencv8_4cam in f64: the frame blocks' solve at K = 69."""
    from mrcal_tpu_torch import problems
    return timed_solve(
        torch, "opencv8_4cam",
        problems.perturbed_oi(problems.opencv8_4cam(), seed=1),
        (131752, 572), CAM4_F64_RMS, CAM4_F64_RMS_TOL, CAM4_NITER_RANGE)


def phase_splined(torch):
    """splined_30x18 through the spline-window normal equations: f64 (the
    fused solve at K = 1083), mixed (the f32 phase's lazy Hessian) and the
    float32-H polish."""
    from mrcal_tpu_torch import optimize, problems
    from mrcal_tpu_torch.convert import from_reference
    from mrcal_tpu_torch.optimize.solver import _lazy_h_K, lm_solve
    phase = "splined_30x18"
    oi, f64 = timed_solve(
        torch, phase, problems.perturbed_oi(problems.splined_30x18(), seed=1),
        (34008, 1586), SPLINED_F64_RMS, SPLINED_F64_RMS_TOL,
        SPLINED_NITER_RANGE)
    if f64["fused_K"] != SPLINED_SHAPES[0][2]:
        fail(f"[{phase}] the fused solve ran at K = {f64['fused_K']}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = optimize(precision="mixed", **SOLVE_KW, **_copy(oi))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rms = stats["rms_reproj_error__pixels"]
    n_pol = stats["niterations_polish"]
    spec, arrays, b0 = from_reference(oi, device="cuda")
    lazy_K = _lazy_h_K(spec, torch.float32, b0.device)
    log(f"[{phase}] mixed (f32 phase lazy-H K = {lazy_K}): rms {rms!r} px, "
        f"{stats['niterations'] - n_pol} f32 + {n_pol} f64 iterations, "
        f"{wall:.4f} s wall, phases {stats['time_s']}")
    if lazy_K != 4 or not abs(rms - SPLINED_F64_RMS) <= SPLINED_MIXED_RMS_TOL:
        fail(f"[{phase}] mixed rms {rms!r} (lazy K {lazy_K})")
    mixed = dict(rms=rms, niterations_f32=stats["niterations"] - n_pol,
                 niterations_polish=n_pol, wall_s=wall, lazy_K=lazy_K)

    # the float32-H polish: the mixed pipeline's f64 phase with H and C
    # assembled in float32 under the float64 gradient
    static_idx = dict(board=oi["indices_frame_camintrinsics_camextrinsics"],
                      point=np.zeros((0, 3), np.int64))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b32, _, n32, _ = lm_solve(spec, arrays, b0, static_idx,
                              dtype=torch.float32, quiet=True, **SOLVE_KW)
    _, E, niter, ne = lm_solve(spec, arrays, b32.to(torch.float64),
                               static_idx, h32=True, max_iterations=300,
                               update_threshold=SOLVE_KW["update_threshold"])
    rms = float(np.sqrt(float(E) / spec.Nmeasurements))
    wall = time.perf_counter() - t0
    log(f"[{phase}] mixed with the f32-H polish: rms {rms!r} px in {n32} "
        f"f32 + {niter} f64 iterations, {wall:.4f} s wall (H "
        f"{ne['Hcc'].dtype}, g {ne['g_c'].dtype}); plain f64: "
        f"{f64['niterations']} iterations, {f64['wall_s']:.4f} s")
    if ne["Hcc"].dtype != torch.float32 or \
            not abs(rms - SPLINED_F64_RMS) <= SPLINED_H32_RMS_TOL:
        fail(f"[{phase}] f32-H polish rms {rms!r}")
    h32 = dict(rms=rms, niterations_f32=n32, niterations=niter, wall_s=wall)
    f64.update(mixed=mixed, h32=h32)
    return oi, f64


def phase_callback(torch, phase, oi):
    """optimizer_callback on the card against the CPU: the same sparse
    structure, and x and J to CALLBACK_REL_TOL of their largest entry."""
    from mrcal_tpu_torch import optimizer_callback
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    b_g, x_g, J_g = optimizer_callback(**_copy(oi))
    wall = time.perf_counter() - t0
    b_c, x_c, J_c = optimizer_callback(device="cpu", **_copy(oi))
    err_b = float(np.abs(b_g - b_c).max() / np.abs(b_c).max())
    err_x = float(np.abs(x_g - x_c).max() / np.abs(x_c).max())
    same = (J_g.shape == J_c.shape and J_g.nnz == J_c.nnz
            and np.array_equal(J_g.indptr, J_c.indptr)
            and np.array_equal(J_g.indices, J_c.indices))
    err_J = (float(np.abs(J_g.data - J_c.data).max()
                   / np.abs(J_c.data).max()) if same else float("nan"))
    log(f"[callback] {phase}: J {J_g.shape}, {J_g.nnz} stored entries "
        f"(CPU {J_c.shape}, {J_c.nnz}), card {wall:.3f} s; card vs CPU: b "
        f"{err_b:.3e}, x {err_x:.3e}, J {err_J:.3e} of the largest entry "
        f"(tol {CALLBACK_REL_TOL:g})")
    if not same:
        fail(f"optimizer_callback {phase}: the card's sparse structure "
             "differs from the CPU's")
    if phase == "splined_30x18":
        # a board row: its 4x4 window on both surfaces, its frame, the warp
        nb = 2 * 84 * 14 * 14
        per_row = np.diff(J_g.indptr)[:nb]
        if not (per_row == 32 + 6 + 2).all():
            fail(f"optimizer_callback {phase}: board rows store "
                 f"{sorted(set(per_row.tolist()))} entries, not 40")
    if not (err_b <= CALLBACK_REL_TOL and err_x <= CALLBACK_REL_TOL
            and err_J <= CALLBACK_REL_TOL):
        fail(f"optimizer_callback {phase}: card and CPU disagree")
    return dict(shape=list(J_g.shape), nnz=int(J_g.nnz), wall_s=wall,
                rel_err_b=err_b, rel_err_x=err_x, rel_err_J=err_J)


def phase_check_gradient(torch, **mk):
    """optimize(check_gradient=True) on the card against the CPU, on a
    small board problem: the same columns checked, and the same worst
    relative error within CHECK_GRADIENT_ABS_TOL."""
    from mrcal_tpu_torch import optimize, problems
    oi = problems.make_problem(device="cpu", **(mk or dict(
        Ncameras=2, Nframes=4, W=4, H=3)))[0]
    t0 = time.perf_counter()
    s_g = optimize(check_gradient=True, **_copy(oi))
    wall = time.perf_counter() - t0
    s_c = optimize(check_gradient=True, device="cpu", **_copy(oi))
    d = abs(s_g["worst_relative_error"] - s_c["worst_relative_error"])
    log(f"[callback] check_gradient {oi['lensmodel']} on the card: "
        f"{s_g['ncols_checked']} "
        f"columns in {wall:.3f} s, worst relative error "
        f"{s_g['worst_relative_error']:.6e} (column {s_g['worst_ivar']}); "
        f"CPU {s_c['worst_relative_error']:.6e} (column "
        f"{s_c['worst_ivar']}); difference {d:.3e} (tol "
        f"{CHECK_GRADIENT_ABS_TOL:g})")
    if not (s_g["ncols_checked"] == s_c["ncols_checked"]
            and s_g["worst_relative_error"] < 1e-5
            and d <= CHECK_GRADIENT_ABS_TOL):
        fail("check_gradient: the card's report differs from the CPU's")
    return dict(ncols_checked=s_g["ncols_checked"], wall_s=wall,
                worst_relative_error=s_g["worst_relative_error"],
                worst_relative_error_cpu=s_c["worst_relative_error"])


def phase_triangulate(torch):
    """The public two-view wrappers (with get_gradients), the pose
    functions and unproject_core on the card against the CPU.  The
    wrappers get numpy arrays and no device: the card is their default."""
    from mrcal_tpu_torch import (R_from_r, compose_r, compose_rt, lensmodels,
                                 rotate_point_R, rotate_point_r,
                                 transform_point_rt, triangulation)
    rng = np.random.default_rng(4)
    N = 4096
    p = rng.normal(size=(N, 3)) * [2.0, 1.0, 1.0] + [0.0, 0.0, 8.0]
    t01 = np.array([1.0, 0.1, -0.2])
    R01 = R_from_r([0.02, -0.1, 0.03], device="cpu").numpy()
    v0 = p + rng.normal(size=(N, 3)) * 0.01
    v1 = p - t01 + rng.normal(size=(N, 3)) * 0.01
    v1[0] = -v1[0]                         # diverging rays: (0,0,0)
    v1_local = v1 @ R01
    Rt01 = np.concatenate([R01, t01[None]], axis=0)
    calls = {f"triangulate_{m}": (getattr(triangulation, "triangulate_" + m),
                                  (v0, v1, t01), dict(get_gradients=True))
             for m in ("geometric", "leecivera_l1", "leecivera_linf",
                       "leecivera_mid2", "leecivera_wmid2")}
    calls["triangulate_lindstrom"] = (triangulation.triangulate_lindstrom,
                                      (v0, v1_local, Rt01),
                                      dict(get_gradients=True))
    calls["triangulate_leecivera_mid2 v_are_local"] = (
        triangulation.triangulate_leecivera_mid2, (v0, v1_local),
        dict(v_are_local=True, Rt01=Rt01))
    calls["rotate_point_R"] = (rotate_point_R, (R01, v1_local),
                               dict(get_gradients=True))
    r = rng.normal(size=(3, N, 3)) * 0.3
    rt = np.concatenate([r, rng.normal(size=(3, N, 3))], axis=-1)
    calls["R_from_r"] = (R_from_r, (r[0],), dict(get_gradients=True))
    for name, fn, a in (("rotate_point_r", rotate_point_r, r[0]),
                        ("transform_point_rt", transform_point_rt, rt[0])):
        for inverted in (False, True):
            calls[f"{name} inverted={inverted}"] = (
                fn, (a, v1), dict(get_gradients=True, inverted=inverted))
    for name, fn, a in (("compose_r", compose_r, r),
                        ("compose_rt", compose_rt, rt)):
        calls[f"{name} three-way"] = (fn, tuple(a), {})
        for flags in ({}, dict(inverted0=True), dict(inverted1=True)):
            calls[f"{name} get_gradients {flags}"] = (
                fn, tuple(a[:2]), dict(get_gradients=True, **flags))
    worst = {}
    for name, (fn, args, kw) in calls.items():
        out_g = fn(*args, **kw)
        out_c = fn(*args, device="cpu", **kw)
        if not isinstance(out_g, tuple):
            out_g, out_c = (out_g,), (out_c,)
        if not all(g.device.type == "cuda" for g in out_g):
            fail(f"[triangulate] {name} did not run on the card")
        errs = [rel_err(g.cpu(), c) for g, c in zip(out_g, out_c)]
        if not all(torch.isfinite(g).all() for g in out_g):
            fail(f"[triangulate] {name}: non-finite output on the card")
        worst[name] = max(errs)
    for model, intr in (("LENSMODEL_PINHOLE", [800., 780., 799.5, 499.5]),
                        ("LENSMODEL_OPENCV8",
                         [800., 780., 799.5, 499.5, -0.05, 0.02, 1e-3,
                          -1e-3, 5e-3, 1e-3, -1e-3, 1e-3])):
        intr = torch.tensor(intr, dtype=torch.float64)
        q = lensmodels.project_core(torch.as_tensor(p), intr, model)
        v_c = lensmodels.unproject_core(q, intr, model)
        v_g = lensmodels.unproject_core(q.cuda(), intr.cuda(), model)
        if v_g.device.type != "cuda" or not torch.isfinite(v_g).all():
            fail(f"[triangulate] unproject_core {model} on the card")
        worst[f"unproject_core {model}"] = rel_err(v_g.cpu(), v_c)
    for name, e in worst.items():
        log(f"[triangulate] {name}: card vs CPU {e:.3e} of the largest "
            f"entry (tol {TRIANGULATE_REL_TOL:g})")
    if not all(e <= TRIANGULATE_REL_TOL for e in worst.values()):
        fail("[triangulate] the card and the CPU disagree")
    return worst


def batch_units(base, P, noise_px):
    """Unit i of a batch: perturbed_oi(base, seed=1+i), and for i >= 1
    N(0, noise_px) on its board x, y from default_rng(1000 + i)."""
    from mrcal_tpu_torch import problems
    units = []
    for i in range(P):
        oi = problems.perturbed_oi(base, seed=1 + i)
        if i and noise_px:
            obs = oi["observations_board"]
            obs[..., :2] += np.random.default_rng(1000 + i).normal(
                0.0, noise_px, obs[..., :2].shape)
        units.append(oi)
    return units


def drop_views(oi, views):
    """A unit that misses some board views (as tests/test_optimize_batch.py
    drops them)."""
    keep = np.ones(len(oi["indices_frame_camintrinsics_camextrinsics"]),
                   bool)
    keep[views] = False
    oi["observations_board"] = oi["observations_board"][keep]
    oi["indices_frame_camintrinsics_camextrinsics"] = \
        oi["indices_frame_camintrinsics_camextrinsics"][keep]


class KernelShapes:
    """Records the (B, n, K) shape of each call of the Schur step's two
    kernel wrappers, by wrapper; the wrappers and their counts stay as
    they are."""

    NAMES = ("cholesky_factor_solve", "cholesky_solve_factored")

    def __enter__(self):
        from mrcal_tpu_torch.optimize import solver
        self.solver = solver
        self.saved = {n: getattr(solver, n) for n in self.NAMES}
        self.shapes = {n: [] for n in self.NAMES}
        for n, fn in self.saved.items():
            def rec(A, rhs, _n=n, _fn=fn):
                self.shapes[_n].append(tuple(rhs.shape))
                return _fn(A, rhs)
            setattr(solver, n, rec)
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.solver, n, fn)


def _E(stats):
    return float(np.sum(np.asarray(stats["x"]) ** 2))


def timed_batch(torch, phase, units, single_wall, precision="f64",
                solve_kw=SOLVE_KW):
    """A warm-up, then one timed optimize_batch of `units`, with the
    kernels' launch counts and shapes and the peak memory, printed beside
    P times the single solve's wall."""
    from mrcal_tpu_torch import optimize_batch
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    P = len(units)
    t0 = time.perf_counter()
    # (mixed: its f32 phase alone, as the f64 polish runs its own count)
    optimize_batch([_copy(u) for u in units],
                   precision="f32" if precision == "mixed" else precision,
                   update_threshold=SOLVE_KW["update_threshold"],
                   max_iterations=2)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    batch = [_copy(u) for u in units]
    torch.cuda.reset_peak_memory_stats()
    bc.reset_launches()
    with KernelShapes() as ks:
        t0 = time.perf_counter()
        stats = optimize_batch(batch, precision=precision, **solve_kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(bc.launches)
    peak = torch.cuda.max_memory_allocated()
    n = np.array([s["niterations"] for s in stats])
    lockstep = int(n.max())
    summary = dict(
        P=P, precision=precision, wall_s=wall, warmup_s=warm,
        lockstep_iterations=lockstep,
        unit_iterations=dict(min=int(n.min()), median=float(np.median(n)),
                             max=lockstep),
        problems_per_s=P / wall, ms_per_lockstep_iteration=wall / lockstep
        * 1e3, peak_memory_bytes=peak, launches=launches,
        shapes={k: sorted(set(v)) for k, v in ks.shapes.items()},
        single_wall_s=single_wall,
        P_times_single_wall_s=(P * single_wall if single_wall else None))
    log(f"[{phase}] {precision} batch of {P}"
        + ("" if solve_kw is SOLVE_KW else f" ({solve_kw})")
        + f": {wall:.4f} s wall (warm-up "
        f"{warm:.2f} s), {lockstep} lockstep iterations, per unit "
        f"{n.min()} / {np.median(n):g} / {n.max()} (min / median / max); "
        f"{P / wall:.2f} problems/s, {wall / lockstep * 1e3:.3f} ms per "
        f"lockstep iteration; peak memory {peak / 2**30:.3f} GiB; launches "
        f"{launches}, shapes {summary['shapes']}"
        + (f"; P x single solve {P * single_wall:.4f} s"
           if single_wall else ""))
    for i, s in enumerate(stats):
        if not (np.isfinite(s["x"]).all() and np.isfinite(s["b_packed"]).all()
                and np.isfinite(s["rms_reproj_error__pixels"])):
            fail(f"[{phase}] unit {i}: non-finite result")
    return batch, stats, summary


def check_batch_launches(phase, summary, shapes):
    """One fused launch at shapes[0] and one back-substitution at
    shapes[1] per lockstep iteration; none at all where shapes is
    None."""
    launches = summary["launches"]
    if shapes is None:
        if any(launches.values()):
            fail(f"[{phase}] launched batched-Cholesky kernels {launches}; "
                 "this path has no frame or point blocks")
        return
    check_launches_per_iteration(phase, launches,
                                 summary["lockstep_iterations"])
    want = dict(zip(KernelShapes.NAMES, ([tuple(shapes[0])],
                                         [tuple(shapes[1])])))
    if summary["shapes"] != want:
        fail(f"[{phase}] the kernels ran at {summary['shapes']}, not "
             f"{want}")


def check_unit0(phase, stats, rms_ref, rms_tol, niter_range):
    rms = stats[0]["rms_reproj_error__pixels"]
    niter = stats[0]["niterations"]
    log(f"[{phase}] unit 0: rms {rms!r} px in {niter} iterations "
        f"(gate {rms_ref!r} +- {rms_tol:g}"
        + (f", {niter_range[0]}-{niter_range[1]} iterations)"
           if niter_range else ")"))
    if not abs(rms - rms_ref) <= rms_tol:
        fail(f"[{phase}] unit 0 rms {rms!r} is not within {rms_tol} of "
             f"{rms_ref!r}")
    if niter_range and not niter_range[0] <= niter <= niter_range[1]:
        fail(f"[{phase}] unit 0 took {niter} iterations")


def phase_batch_fleet(torch, single_wall):
    """64 opencv8_1cam units, padded to one structure, in lockstep."""
    from mrcal_tpu_torch import (optimize, optimize_batch,
                                 pad_problems_to_common_structure, problems)
    from mrcal_tpu_torch.optimize import spec_from_inputs
    phase = "batch fleet"
    t0 = time.perf_counter()
    units = batch_units(problems.opencv8_1cam(), FLEET_P, FLEET_NOISE_PX)
    for i in range(FLEET_DROPPED_FROM, FLEET_P):
        j = i - FLEET_DROPPED_FROM
        drop_views(units[i], [j, j + 42])
    fleet = pad_problems_to_common_structure(units)
    spec = spec_from_inputs(**fleet[0])
    ncorners = sum(np.asarray(u["observations_board"]).shape[0]
                   for u in fleet) * 14 * 14
    log(f"[{phase}] {FLEET_P} units built and padded in "
        f"{time.perf_counter() - t0:.2f} s: {FLEET_P} x "
        f"{spec.Nmeasurements} measurements, {ncorners} corners, Nstate "
        f"{spec.Nstate}")
    if (spec.Nmeasurements, spec.Nstate, ncorners) != (32938, 518,
                                                       FLEET_P * 16464):
        fail(f"[{phase}] the fleet has the wrong shape")

    small = {}
    for P in (1, 8):
        _, st, small[P] = timed_batch(torch, f"{phase} P={P}", fleet[:P],
                                      single_wall)
        if P == 1:
            stats_p1 = st
    batch, stats, summary = timed_batch(torch, phase, fleet, single_wall)
    check_batch_launches(phase, summary, FLEET_SHAPES)
    check_unit0(phase, stats, F64_RMS, F64_RMS_TOL, F64_NITER_RANGE)
    s0 = optimize(precision="f64", **SOLVE_KW, **_copy(units[0]))
    e1 = abs(_E(stats_p1[0]) - _E(s0)) / _E(s0)
    log(f"[{phase}] batch of 1 against optimize(): E rel diff {e1:.3e} "
        f"(tol {BATCH_P1_E_RTOL:g})")
    if not e1 <= BATCH_P1_E_RTOL:
        fail(f"[{phase}] the batch of one differs from optimize()")

    # to the end of the tails: the batch against units solved alone
    _, stats_deep, deep = timed_batch(torch, phase, fleet, single_wall,
                                      solve_kw=DEEP_KW)
    alone = dict(E_rel_batch_of_one=e1)
    for i in FLEET_CHECKED_UNITS:
        s = optimize(precision="f64", **DEEP_KW, **_copy(units[i]))
        e_rel = abs(_E(stats_deep[i]) - _E(s)) / _E(s)
        db = float(np.abs(stats_deep[i]["b_packed"] - s["b_packed"]).max())
        alone[i] = dict(E_rel=e_rel, b_abs=db, niterations=s["niterations"],
                        niterations_batch=stats_deep[i]["niterations"])
        log(f"[{phase}] unit {i} alone, ftol 1e-10: {s['niterations']} "
            f"iterations (batch {stats_deep[i]['niterations']}), E rel diff "
            f"{e_rel:.3e} (tol {BATCH_E_RTOL:g}), b_packed max diff "
            f"{db:.3e} (tol {BATCH_B_ATOL:g})")
        if not (e_rel <= BATCH_E_RTOL and db <= BATCH_B_ATOL):
            fail(f"[{phase}] unit {i}: the batch and optimize() disagree")

    # mixed, as the main path runs it: unit 0 to the main path's gate; the
    # other units' differences from their f64 results are printed
    _, stats_mx, mixed = timed_batch(torch, phase, fleet, single_wall,
                                     precision="mixed")
    diffs = np.array([a["rms_reproj_error__pixels"]
                      - b["rms_reproj_error__pixels"]
                      for a, b in zip(stats_mx, stats)])
    pol = [s["niterations_polish"] for s in stats_mx]
    over = [int(i) for i in np.nonzero(np.abs(diffs) > MIXED_RMS_TOL)[0]]
    rms0 = stats_mx[0]["rms_reproj_error__pixels"]
    log(f"[{phase}] mixed: unit 0 rms {rms0!r} px (gate {F64_RMS!r} +- "
        f"{MIXED_RMS_TOL:g}, {diffs[0]:+.3e} px from its f64 rms); all "
        f"units' rms minus f64 rms: min {diffs.min():+.3e}, median "
        f"{np.median(diffs):+.3e}, max {diffs.max():+.3e} px; beyond "
        f"{MIXED_RMS_TOL:g} px: units {over}; f64 polish iterations per "
        f"unit {min(pol)} / {np.median(pol):g} / {max(pol)}")
    if not (abs(rms0 - F64_RMS) <= MIXED_RMS_TOL
            and abs(diffs[0]) <= MIXED_RMS_TOL):
        fail(f"[{phase}] mixed unit 0 rms {rms0!r}")
    mixed.update(rms_diff_from_f64=dict(
        min=float(diffs.min()), median=float(np.median(diffs)),
        max=float(diffs.max())), units_beyond_tol=over)
    summary.update(P1=small[1], P8=small[8], deep_ftol_1e_10=deep,
                   alone=alone, mixed=mixed)
    return fleet, summary


def phase_batch_rig16(torch, single_wall):
    """8 rig16cam units in lockstep: the frame blocks at K = 285."""
    from mrcal_tpu_torch import problems
    phase = "batch rig16cam x 8"
    units = batch_units(problems.rig16cam(), RIG16_BATCH_P, FLEET_NOISE_PX)
    _, stats, summary = timed_batch(torch, phase, units, single_wall)
    check_batch_launches(phase, summary, RIG16_BATCH_SHAPES)
    check_unit0(phase, stats, RIG16_F64_RMS, RIG16_F64_RMS_TOL, None)
    return units, summary


def phase_batch_sfm(torch, single_wall):
    """4 sfm_triangulated units in lockstep: no block kernel."""
    from mrcal_tpu_torch import problems
    phase = "batch sfm_triangulated x 4"
    units = batch_units(problems.sfm_triangulated(), SFM_BATCH_P, 0.0)
    _, stats, summary = timed_batch(torch, phase, units, single_wall)
    check_batch_launches(phase, summary, None)
    check_unit0(phase, stats, SFM_F64_RMS, SFM_F64_RMS * SFM_F64_RMS_REL_TOL,
                SFM_BATCH_NITER_RANGE)
    return units, summary


def mesh_solve(torch, phase, oi, mesh, shape):
    """One counted f64 solve of oi on the mesh (None: unsharded): the
    kernels' launch counts and shapes, the mesh's collective counts and
    the wall."""
    from mrcal_tpu_torch import optimize
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    kw = {} if mesh is None else dict(mesh=mesh)
    oi = _copy(oi)
    if mesh is not None:
        mesh.reset_counts()
    torch.cuda.synchronize()
    bc.reset_launches()
    with KernelShapes() as ks:
        t0 = time.perf_counter()
        stats = optimize(precision="f64", **SOLVE_KW, **kw, **oi)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    niter = stats["niterations"]
    out = dict(rms=stats["rms_reproj_error__pixels"], E=_E(stats),
               niterations=niter, wall_s=wall,
               ms_per_iteration=wall / niter * 1e3,
               launches=dict(bc.launches),
               shapes={k: sorted(set(v)) for k, v in ks.shapes.items()})
    if mesh is not None:
        out["collectives"] = dict(mesh.counts)
        out["bytes_reduced"] = mesh.bytes_reduced
    log(f"[{phase}] f64{'' if mesh is None else ' on ' + repr(mesh)}: rms "
        f"{out['rms']!r} px in {niter} iterations, {wall:.4f} s, "
        f"{out['ms_per_iteration']:.3f} ms/iteration, launches "
        f"{out['launches']}, shapes {out['shapes']}"
        + ("" if mesh is None else f", collectives {out['collectives']}"))
    if not np.isfinite(stats["x"]).all():
        fail(f"[{phase}] non-finite residuals")
    if shape is not None:
        check_launches_per_iteration(phase, out["launches"], niter)
        want = {"cholesky_factor_solve": [shape],
                "cholesky_solve_factored": [shape[:2] + (1,)]}
        if out["shapes"] != want:
            fail(f"[{phase}] the kernels ran at {out['shapes']}, not {want}")
    return stats, out


def check_bytes(phase, name, m):
    """The bytes all-reduced per normal-equation evaluation equal
    collective_bytes_per_iteration's count for the solve (f64, no
    float32 H)."""
    log(f"[{phase}] {name}: {m['bytes_per_evaluation']:.0f} bytes all-reduced "
        f"per evaluation, collective_bytes_per_iteration "
        f"{m['collective_bytes_per_iteration']}")
    if m["bytes_per_evaluation"] != m["collective_bytes_per_iteration"]:
        fail(f"[{phase}] {name}: the bytes all-reduced per evaluation differ "
             "from collective_bytes_per_iteration")


def phase_mesh_nccl1(torch, oi_main, oi_splined):
    """opencv8_1cam and splined_30x18 by optimize(mesh=1) on a one-rank
    NCCL group, against the unsharded solve in the same call."""
    import torch.distributed as dist
    from mrcal_tpu_torch import optimize
    from mrcal_tpu_torch.optimize import spec_from_inputs
    from mrcal_tpu_torch.parallel import (collective_bytes_per_iteration,
                                          make_mesh)
    phase = "mesh nccl1"
    torch.cuda.set_device(0)
    out = {}
    with tempfile.TemporaryDirectory() as workdir:
        dist.init_process_group("nccl", init_method=f"file://{workdir}/store",
                                rank=0, world_size=1)
        try:
            mesh = make_mesh(1)
            optimize(mesh=mesh, precision="f64", **SOLVE_KW, **_copy(oi_main))
            stats_m, m = mesh_solve(torch, phase, oi_main, mesh, (84, 6, 15))
            stats_u, u = mesh_solve(torch, phase, oi_main, None, None)
            dE = abs(m["E"] - u["E"]) / u["E"]
            log(f"[{phase}] E {m['E']!r} on the mesh, {u['E']!r} unsharded: "
                f"{dE:.3e} relative; b_packed differ by "
                f"{np.abs(stats_m['b_packed'] - stats_u['b_packed']).max():.3e}")
            if not abs(m["rms"] - F64_RMS) <= F64_RMS_TOL:
                fail(f"[{phase}] rms {m['rms']!r} is not within "
                     f"{F64_RMS_TOL} of {F64_RMS}")
            if not F64_NITER_RANGE[0] <= m["niterations"] <= \
                    F64_NITER_RANGE[1]:
                fail(f"[{phase}] {m['niterations']} iterations")
            if not dE <= MESH_E_RTOL:
                fail(f"[{phase}] E is {dE:.3e} relative from the unsharded "
                     "solve's")
            # ms per iteration in turns: unsharded, mesh, mesh, unsharded
            walls = {"unsharded": [], "mesh": []}
            for which in ("unsharded", "mesh", "mesh", "unsharded"):
                walls[which].append(mesh_solve(
                    torch, phase, oi_main,
                    mesh if which == "mesh" else None,
                    None)[1]["ms_per_iteration"])
            spec = spec_from_inputs(**oi_main)
            c = m["collectives"]
            formula, _ = collective_bytes_per_iteration(spec)
            out["opencv8_1cam"] = dict(
                mesh=m, unsharded=u, E_rel_diff=dE,
                ms_per_iteration_turns=walls,
                all_reduce_per_evaluation=c["all_reduce"]
                / c["normal_equations"],
                bytes_per_evaluation=m["bytes_reduced"]
                / c["normal_equations"],
                collective_bytes_per_iteration=formula)
            log(f"[{phase}] ms per iteration in turns: unsharded "
                f"{walls['unsharded']}, mesh {walls['mesh']}; all-reduce "
                f"calls per normal-equation evaluation "
                f"{out['opencv8_1cam']['all_reduce_per_evaluation']:g}, "
                f"{out['opencv8_1cam']['bytes_per_evaluation']:g} bytes "
                f"each (collective_bytes_per_iteration: {formula})")
            check_bytes(phase, "opencv8_1cam", out["opencv8_1cam"])

            oi_mx = _copy(oi_main)
            stats = optimize(mesh=mesh, precision="mixed", **SOLVE_KW,
                             **oi_mx)
            rms = stats["rms_reproj_error__pixels"]
            log(f"[{phase}] mixed on the mesh: rms {rms!r} px in "
                f"{stats['niterations']} iterations")
            if not abs(rms - F64_RMS) <= MIXED_RMS_TOL:
                fail(f"[{phase}] mixed rms {rms!r}")
            out["opencv8_1cam"]["mixed_rms"] = rms

            _, sp = mesh_solve(torch, phase, oi_splined, mesh,
                               SPLINED_SHAPES[0])
            if not abs(sp["rms"] - SPLINED_F64_RMS) <= SPLINED_F64_RMS_TOL:
                fail(f"[{phase}] splined rms {sp['rms']!r}")
            if not SPLINED_NITER_RANGE[0] <= sp["niterations"] <= \
                    SPLINED_NITER_RANGE[1]:
                fail(f"[{phase}] splined: {sp['niterations']} iterations")
            c = sp["collectives"]
            sp.update(bytes_per_evaluation=sp["bytes_reduced"]
                      / c["normal_equations"],
                      collective_bytes_per_iteration=
                      collective_bytes_per_iteration(
                          spec_from_inputs(**oi_splined))[0])
            check_bytes(phase, "splined_30x18", sp)
            out["splined_30x18"] = sp
        finally:
            dist.destroy_process_group()
    return out, stats_u


def _mesh_gloo2_rank(mesh, oi):
    """A rank of the [mesh gloo2] phase: opencv8_1cam by optimize(mesh=2),
    with the rank's kernel launches and collectives."""
    sys.path.insert(0, ROOT)
    import torch
    from mrcal_tpu_torch import optimize
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    optimize(mesh=mesh, precision="f64", **dict(SOLVE_KW, max_iterations=2),
             **_copy(oi))
    mesh.reset_counts()
    bc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = optimize(mesh=mesh, precision="f64", **SOLVE_KW, **_copy(oi))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(rank=mesh.rank, device=str(mesh.device), b=stats["b_packed"],
                E=_E(stats), rms=stats["rms_reproj_error__pixels"],
                niterations=stats["niterations"], wall_s=wall,
                launches=dict(bc.launches), collectives=dict(mesh.counts))


def phase_mesh_gloo2(torch, oi_main, unsharded):
    """Two ranks on the one card over gloo, against the unsharded solve;
    then dryrun_multichip(2)."""
    from mrcal_tpu_torch.parallel import dryrun_multichip, spawn
    phase = "mesh gloo2"
    t0 = time.perf_counter()
    ranks = spawn(_mesh_gloo2_rank, 2, oi_main)
    spawn_s = time.perf_counter() - t0
    b_u = unsharded["b_packed"]
    for r in ranks:
        dE = abs(r["E"] - _E(unsharded)) / _E(unsharded)
        db = float(np.abs(r["b"] - b_u).max())
        r.update(E_rel_diff=dE, b_abs_diff=db,
                 ms_per_iteration=r["wall_s"] / r["niterations"] * 1e3)
        log(f"[{phase}] rank {r['rank']} on {r['device']}: rms {r['rms']!r} "
            f"px in {r['niterations']} iterations, {r['wall_s']:.4f} s "
            f"({r['ms_per_iteration']:.3f} ms/iteration); E {dE:.3e} "
            f"relative and b {db:.3e} from the unsharded solve; launches "
            f"{r['launches']}, collectives {r['collectives']}")
        if not (dE <= MESH_E_RTOL and db <= MESH_B_ATOL):
            fail(f"[{phase}] rank {r['rank']} differs from the unsharded "
                 "solve")
        check_launches_per_iteration(f"{phase} rank {r['rank']}",
                                     r["launches"], r["niterations"])
    if not np.array_equal(ranks[0]["b"], ranks[1]["b"]):
        fail(f"[{phase}] the ranks' b differ")
    t0 = time.perf_counter()
    dry = dryrun_multichip(2)
    log(f"[{phase}] dryrun_multichip(2) (gloo, two ranks sharing the "
        f"card): {dry} in "
        f"{time.perf_counter() - t0:.1f} s")
    for r in ranks:
        r.pop("b")
    return dict(ranks=ranks, spawn_s=spawn_s, dryrun=dry)


def _solved(oi):
    """A converged f64 solve of oi on the card (the inputs, copied, with
    the solution written back)."""
    from mrcal_tpu_torch import optimize
    oi = _copy(oi)
    optimize(precision="f64", **SOLVE_KW, **oi)
    return oi


def odd_frames(oi):
    """opencv8_1cam on its odd-numbered frames (one camera: one
    observation per frame)."""
    oi = _copy(oi)
    idx = oi["indices_frame_camintrinsics_camextrinsics"]
    keep = idx[:, 0] % 2 == 1
    idx = idx[keep].copy()
    idx[:, 0] //= 2
    oi["indices_frame_camintrinsics_camextrinsics"] = idx
    oi["observations_board"] = oi["observations_board"][keep]
    oi["frames_rt_toref"] = oi["frames_rt_toref"][1::2]
    return oi


def _sync_time(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def uncertainty_split(torch, model, p, method, atinfinity):
    """One projection_uncertainty call on the card in its stages: J (the
    problem's upload, its Jacobian's triplets and the dense J), the
    factor (JtJ's Cholesky factor, from the QR of J), F's Jacobian (with
    Kpacked for the cross-reprojection methods) and the propagation
    (sigma, the solve, Jobs A and the 2x2 products), seconds each."""
    from mrcal_tpu_torch import model_analysis as ma
    out = {}
    prob, out["J_s"] = _sync_time(torch, lambda: ma._Solved(
        model.optimization_inputs(), p.device))
    _, dt = _sync_time(torch, lambda: prob.J)
    out["J_s"] += dt
    _, out["factor_s"] = _sync_time(torch, lambda: prob.factorization)
    dq, out["F_jacobian_s"] = _sync_time(torch, lambda: ma._dq_db(
        prob, p.reshape(-1, 3), model.icam_intrinsics() or 0, method,
        atinfinity))
    _, out["propagate_s"] = _sync_time(torch, lambda: ma._propagate(
        prob, dq, ma._observed_pixel_uncertainty(prob)))
    return out


def uncertainty_conditioning(torch, phase, model, p):
    """Why the card and the CPU agree only to ~1e-8 on the bench
    problems: JtJ's computed eigenvalues and whether its Cholesky exists;
    mean-pcam at 1 m taken apart stage by stage on the card and the CPU
    (J relative to its largest entry and per entry, the factor L, dF/db,
    Var); and Var's move under a 1-ulp random perturbation of J."""
    from mrcal_tpu_torch import model_analysis as ma
    stages = {}
    for where, dev in (("card", p.device), ("cpu", torch.device("cpu"))):
        prob = ma._Solved(model.optimization_inputs(), dev)
        dq = ma._dq_db(prob, p.reshape(-1, 3).to(dev), 0, "mean-pcam", False)
        stages[where] = dict(
            J=prob.J, L=prob.factorization._L, dq=dq,
            Var=ma._propagate(prob, dq, ma._observed_pixel_uncertainty(prob)))
        if where == "card":
            JtJ = prob.J.T @ prob.J
            eig = torch.linalg.eigvalsh(JtJ)
            chol_info = int(torch.linalg.cholesky_ex(JtJ)[1])
            g = torch.Generator(device=dev).manual_seed(0)
            J = prob.J
            prob.J = J * (1 + 2.0 ** -52 * (2 * torch.rand(
                J.shape, generator=g, dtype=J.dtype, device=dev) - 1))
            prob.__dict__.pop("factorization")
            Var_ulp = ma._propagate(prob, dq,
                                    ma._observed_pixel_uncertainty(prob))
    card = {k: v.cpu() for k, v in stages["card"].items()}
    cpu = stages["cpu"]

    def rel(k):
        return float((card[k] - cpu[k]).abs().max() / cpu[k].abs().max())
    out = dict(
        JtJ_eig_min=float(eig[0]), JtJ_eig_max=float(eig[-1]),
        JtJ_cholesky_info=chol_info, J=rel("J"),
        J_per_entry=float(((card["J"] - cpu["J"]).abs()
                           / cpu["J"].abs().clamp_min(1e-300)).max()),
        L=rel("L"), dF_db=rel("dq"), Var=rel("Var"),
        Var_ulp=float((Var_ulp.cpu() - card["Var"]).abs().max()
                      / card["Var"].abs().max()))
    log(f"[{phase}] conditioning: JtJ's eigenvalues {out['JtJ_eig_min']:.3e}"
        f" .. {out['JtJ_eig_max']:.3e}, its Cholesky info "
        f"{chol_info}; mean-pcam at 1 m, card vs CPU: J {out['J']:.2e} of "
        f"its largest entry, {out['J_per_entry']:.2e} per entry; L "
        f"{out['L']:.2e}; dF/db {out['dF_db']:.2e}; Var {out['Var']:.2e}; "
        f"Var under a 1-ulp random perturbation of J {out['Var_ulp']:.2e}")
    return out


def uncertainty_call(torch, phase, model, p, nstate, method, atinfinity,
                     what):
    """projection_uncertainty on the card (a warm-up call, then a timed
    one, then its stages timed apart) against the same call on the CPU."""
    from mrcal_tpu_torch import projection_uncertainty
    kw = dict(method=method, atinfinity=atinfinity, what=what)
    projection_uncertainty(p, model, **kw)
    got, wall = _sync_time(torch, lambda: projection_uncertainty(
        p, model, **kw))
    t0 = time.perf_counter()
    want = projection_uncertainty(p.cpu(), model, device="cpu", **kw)
    wall_cpu = time.perf_counter() - t0
    if not (got.device.type == "cuda" and got.shape == want.shape
            and torch.isfinite(got).all()):
        fail(f"[{phase}] {method} {what}: the card's result is not finite "
             "on the card in the CPU's shape")
    got = got.cpu()
    if what == "covariance":
        err = float((got - want).abs().max() / want.abs().max())
        tol = UNC_COV_TOL
    else:
        err = float(((got - want).abs() / want.abs()).max())
        tol = UNC_STDEV_RTOL
    split = uncertainty_split(torch, model, p, method, atinfinity)
    log(f"[{phase}] {method} {'at infinity' if atinfinity else 'at 1 m'} "
        f"{what} on {tuple(p.shape[:-1])}: Nstate {nstate}, card "
        f"{wall * 1e3:.2f} ms warm (J {split['J_s'] * 1e3:.2f}, factor "
        f"{split['factor_s'] * 1e3:.2f}, F's Jacobian "
        f"{split['F_jacobian_s'] * 1e3:.2f}, propagate "
        f"{split['propagate_s'] * 1e3:.2f} ms), CPU {wall_cpu * 1e3:.1f} "
        f"ms; card vs CPU {err:.3e} (tol {tol:g})")
    if not err <= tol:
        fail(f"[{phase}] {method} {what}: the card and the CPU disagree")
    return dict(method=method, atinfinity=atinfinity, what=what,
                Nstate=nstate, wall_s=wall, wall_cpu_s=wall_cpu, err=err,
                **split)


def phase_uncertainty(torch, oi_main, oi_4cam, oi_splined):
    """projection_uncertainty on converged solves: opencv8_1cam (every
    method, at 1 m and at infinity, covariance and worstdirection-stdev),
    opencv8_4cam camera 2 and splined_30x18 (mean-pcam and ccp at 1 m) on
    the 30 x 22 grid; then projection_diff with uncertainties between the
    main path's model and a solve of its odd-numbered 42 frames, at
    infinity and at 1 m.  Each against the same call on the CPU."""
    from mrcal_tpu_torch import (cameramodel, projection_diff, sample_imager,
                                 unproject)
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    from mrcal_tpu_torch.optimize import spec_from_inputs
    phase = "uncertainty"
    t_phase = time.perf_counter()
    calls = []

    def grid_points(model):
        q = sample_imager(UNC_GRID, None, *model.imagersize())
        return unproject(q, *model.intrinsics(), normalize=True)

    solved = {}
    for name, oi, icam in (("opencv8_1cam", oi_main, 0),
                           ("opencv8_4cam", oi_4cam, 2),
                           ("splined_30x18", oi_splined, 0)):
        solved[name] = _solved(oi)
        model = cameramodel(optimization_inputs=solved[name],
                            icam_intrinsics=icam)
        v = grid_points(model)
        nstate = spec_from_inputs(**solved[name]).Nstate
        if name == "opencv8_1cam":
            model_main = model
            conditioning = uncertainty_conditioning(torch, phase, model, v)
            cases = [(m, inf, what) for m in UNC_METHODS
                     for inf in (False, True)
                     for what in ("covariance", "worstdirection-stdev")]
        else:
            cases = [(m, False, "covariance")
                     for m in ("mean-pcam", "cross-reprojection-ccp")]
        for method, atinfinity, what in cases:
            calls.append(dict(config=name, **uncertainty_call(
                torch, f"{phase} {name}", model, v, nstate, method,
                atinfinity, what)))

    # the odd-numbered frames' solve launches the fused kernel at (42, 6,
    # 15)
    bc.reset_launches()
    oi_odd = _solved(odd_frames(oi_main))
    odd_launches = dict(bc.launches)
    log(f"[{phase}] opencv8_1cam on its odd-numbered frames: "
        f"{len(oi_odd['frames_rt_toref'])} frames, launches {odd_launches}")
    if odd_launches["cholesky_factor_solve"] == 0:
        fail(f"[{phase}] the odd-frame solve launched no fused kernel")
    model_odd = cameramodel(optimization_inputs=oi_odd, icam_intrinsics=0)
    diffs = []
    for distance in (None, 1.0):
        kw = dict(use_uncertainties=True, distance=distance)
        projection_diff([model_main, model_odd], **kw)
        (difflen, _, q0, Rt10), wall = _sync_time(
            torch, lambda: projection_diff([model_main, model_odd], **kw))
        t0 = time.perf_counter()
        difflen_c, _, _, Rt10_c = projection_diff(
            [model_main, model_odd], device="cpu", **kw)
        wall_cpu = time.perf_counter() - t0
        d_len = float((difflen.cpu() - difflen_c).abs().max())
        d_Rt = float((Rt10.cpu() - Rt10_c).abs().max())
        where = "at infinity" if distance is None else "at 1 m"
        log(f"[{phase}] projection_diff {where} with uncertainties on "
            f"{tuple(q0.shape[:-1])}: card {wall * 1e3:.1f} ms warm, CPU "
            f"{wall_cpu * 1e3:.1f} ms; difflen median "
            f"{float(difflen.median()):.6f} px, max "
            f"{float(difflen.max()):.6f} px; card vs CPU: difflen "
            f"{d_len:.3e} px (tol {DIFF_DIFFLEN_TOL:g}), Rt10 {d_Rt:.3e} "
            f"(tol {DIFF_RT10_TOL:g})")
        if not (torch.isfinite(difflen).all() and d_len <= DIFF_DIFFLEN_TOL
                and d_Rt <= DIFF_RT10_TOL):
            fail(f"[{phase}] projection_diff {where}: the card and the CPU "
                 "disagree")
        diffs.append(dict(distance=distance, wall_s=wall, wall_cpu_s=wall_cpu,
                          difflen_err_px=d_len, Rt10_err=d_Rt))
    wall = time.perf_counter() - t_phase
    log(f"[{phase}] phase {wall:.1f} s")
    return dict(calls=calls, diffs=diffs, odd_frames_launches=odd_launches,
                conditioning=conditioning, wall_s=wall)


def phase_profile(torch, phase, oi, wall_unprofiled):
    """Where the time of the f64 solve goes: one more solve under
    torch.profiler; device time by kernel, launches per iteration, the
    device's busy share of the (unprofiled) timed solve, and the device
    time per launch of each batched-Cholesky kernel.  oi: one problem, or
    a list of them, solved as one batch (iterations are then the lockstep
    iterations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mrcal_tpu_torch import optimize, optimize_batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if isinstance(oi, list):
            niter = max(s["niterations"] for s in optimize_batch(
                [_copy(u) for u in oi], precision="f64", **SOLVE_KW))
        else:
            niter = optimize(precision="f64", **SOLVE_KW,
                             **_copy(oi))["niterations"]
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    averages = prof.key_averages()
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    nlaunch = sum(e.count for e in kernels)
    log(f"[profile] {phase} f64 solve: {niter} iterations, "
        f"{wall * 1e3:.1f} ms wall under the profiler; {nlaunch} device "
        "kernels "
        f"({nlaunch / niter:.0f} per iteration), {busy_ms:.2f} ms device "
        f"busy = {busy_ms / (wall_unprofiled * 1e3) * 100:.1f} % of the "
        f"unprofiled solve's wall")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in top[:12]:
        log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
            f"{e.count:6d}x  {e.key[:100]}")
    host = sorted((e for e in averages if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    log(f"[profile] {phase} host self time by op:")
    for e in host[:12]:
        log(f"[profile]   {e.self_cpu_time_total / 1e3:8.3f} ms "
            f"{e.count:6d}x  {e.key[:100]}")
    per_launch = {}
    for name in LAUNCHED:
        ev = [e for e in kernels if name + "_kernel<" in e.key]
        n = sum(e.count for e in ev)
        per_launch[name] = (sum(e.self_device_time_total for e in ev) / n
                            if n else None)
    return dict(iterations=niter, kernels=nlaunch,
                kernels_per_iteration=nlaunch / niter, device_busy_ms=busy_ms,
                device_busy_share=busy_ms / (wall_unprofiled * 1e3)), \
        per_launch


def main():
    if not os.path.isdir(os.path.join(ROOT, "mrcal_tpu_torch")):
        fail("the mrcal_tpu_torch package is not beside chip_smoke.py")
    sys.path.insert(0, ROOT)
    import torch
    from mrcal_tpu_torch.problems import SPLINED_30X18
    t_start = time.perf_counter()

    def stamp(phase):
        log(f"[time] {phase} done at {time.perf_counter() - t_start:.1f} s")

    card, smi = phase_device(torch)
    phase_build()
    phase_kernels(torch)
    stamp("kernel checks")
    # the timed solves run before any profiler session, and the kernels'
    # short profiler sessions before the whole-solve ones (after those,
    # short sessions lost their device events on the card)
    oi_main, main_path = phase_main_path(torch)
    stamp("main")
    others = {}
    for name, phase in (("rig16cam", phase_rig16cam),
                        ("sfm_triangulated", phase_sfm),
                        ("opencv8_4cam", phase_4cam),
                        ("splined_30x18", phase_splined)):
        others[name] = phase(torch)
        stamp(name)
    # loopback only for the process groups' own sockets
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    mesh, unsharded = phase_mesh_nccl1(torch, oi_main,
                                       others["splined_30x18"][0])
    stamp("mesh nccl1")
    mesh["gloo2"] = phase_mesh_gloo2(torch, oi_main, unsharded)
    stamp("mesh gloo2")
    batches = {}
    for name, phase, wall in (
            ("fleet_64x_opencv8_1cam", phase_batch_fleet,
             main_path["f64"]["wall_s"]),
            ("rig16cam_x8", phase_batch_rig16,
             others["rig16cam"][1]["wall_s"]),
            ("sfm_triangulated_x4", phase_batch_sfm,
             others["sfm_triangulated"][1]["wall_s"])):
        batches[name] = phase(torch, wall)
        stamp(name)
    callbacks = {name: phase_callback(torch, name, oi) for name, oi in (
        ("sfm_triangulated", others["sfm_triangulated"][0]),
        ("opencv8_1cam", oi_main),
        ("splined_30x18", others["splined_30x18"][0]))}
    callbacks["check_gradient"] = phase_check_gradient(torch)
    callbacks["check_gradient_splined"] = phase_check_gradient(
        torch, Ncameras=1, Nframes=6, W=8, H=6,
        model=SPLINED_30X18["model"],
        do_optimize_intrinsics_core=False)
    stamp("callbacks")
    triangulate = phase_triangulate(torch)
    stamp("triangulate")
    uncertainty = phase_uncertainty(torch, oi_main,
                                    others["opencv8_4cam"][0],
                                    others["splined_30x18"][0])
    stamp("uncertainty")
    entries, main_path["launch_floor"] = time_kernels(torch, card)
    stamp("kernel times")
    main_path["profile"], per_launch = phase_profile(
        torch, "main", oi_main, main_path["f64"]["wall_s"])
    stamp("main profile")
    for name, (oi, summary) in others.items():
        summary["profile"], _ = phase_profile(torch, name, oi,
                                              summary["wall_s"])
        stamp(f"{name} profile")
    fleet, summary = batches["fleet_64x_opencv8_1cam"]
    summary["profile"], _ = phase_profile(torch, "batch fleet", fleet,
                                          summary["wall_s"])
    stamp("batch fleet profile")
    for e in entries:
        e["launches"] = main_path["f64"]["launches"][e["name"]]
        e["launches_by_path"] = dict(
            opencv8_1cam=e["launches"],
            **{name: summary["launches"][e["name"]]
               for name, (_, summary) in others.items()},
            **{name: summary["launches"][e["name"]]
               for name, (_, summary) in batches.items()},
            mesh_nccl1_opencv8_1cam=mesh["opencv8_1cam"]["mesh"][
                "launches"][e["name"]],
            mesh_nccl1_splined_30x18=mesh["splined_30x18"]["launches"][
                e["name"]],
            mesh_gloo2_opencv8_1cam_rank0=mesh["gloo2"]["ranks"][0][
                "launches"][e["name"]],
            uncertainty_odd_frames_opencv8_1cam=uncertainty[
                "odd_frames_launches"][e["name"]])
        e["device_us_per_launch_main_path"] = per_launch[e["name"]]
    log(f"[main] summary {json.dumps(main_path)}")
    for name, (_, summary) in list(others.items()) + list(batches.items()):
        log(f"[{name}] summary {json.dumps(summary)}")
    log(f"[mesh] summary {json.dumps(mesh)}")
    log(f"[callback] summary {json.dumps(callbacks)}")
    log(f"[triangulate] summary {json.dumps(triangulate)}")
    log(f"[uncertainty] summary {json.dumps(uncertainty)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
