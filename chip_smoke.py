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
   (opencv8_1cam, opencv8_4cam, rig16cam, splined_30x18's K = 1083,
   stereo_opencv8_2cam's K = 33, sfm_points' n = 3 blocks at (14996, 3,
   2385), (14996, 3, 1), (4996, 3, 801) and (4996, 3, 1)), a ragged B, K
   past a warp, B = 0 and a large-B sweep, f64 and f32.
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
   cahvor_1cam and cahvore_1cam: opencv8_1cam's problem with the CAHVOR
   model, and with CAHVORE at linearity 0.37 (32935 and 32938
   measurements, 515 and 518 states; the frame blocks are solved against
   K = 12 and K = 15 columns), warm-up, then a timed f64 solve held to
   the JAX package's f64 rms, 0.29588193204700636 and 0.2958303685900879
   px +- 1e-6, in 32 +- 3 and 6 +- 3 iterations, one launch of each path
   kernel per iteration at the asserted shapes; then a converged solve's
   cameramodel: unproject (with gradients) over a 60 x 45 grid and
   project of the result on the card against the CPU, 1e-8 px, and on
   cahvor_1cam projection_uncertainty (mean-pcam, 1 m, the 30 x 22 grid)
   against the CPU.
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
   stereo_opencv8_2cam: two OPENCV8 cameras 0.22 m apart and 84 frames
   of a 14x14 board that both see whole (65876 measurements, 536
   states), made by synthetic_data on the card (held to the same build
   on the CPU, 1e-9 px); a timed f64 solve held to the JAX package's f64
   rms, 0.29857396040360784 px +- 1e-6, reached within 15 + 3 iterations
   (a solve capped there) in 12-24 iterations (where the roundoff tail
   stops differs, see STEREO_NITER; the tails of the card's and the
   CPU's trajectories are printed), the fused kernel at (84, 6, 33) and
   one back-substitution per iteration; the
   solved models triangulate 500 features (drawn from default_rng(5) at
   1-10 m, 0.3 px of noise) with calibration and observation noise
   (Var_cal (500, 3, 500, 3); the warm wall split into its stages, and
   dp/db timed in forward and in reverse mode at 500 and at 5 points),
   and every pixel of camera 0 against a tilted plane
   (480000 pairs; the default method and Lindstrom's), each against the
   CPU in the same process: p to 1e-9 m, the covariances to 1e-7 of
   their largest entry, the dense points to 1e-10 of their range.
   calibrate_from_images: the calibration front end on
   stereo_opencv8_2cam's true geometry (no noise, no perturbation): 168
   8-bit images of 800 x 600 rendered on the card (each pixel's 4 x 4
   supersamples unprojected once per camera by the true OPENCV8
   intrinsics, each frame's rays met with the warped board, a
   checkerboard of 15 x 15 squares whose inner vertices are the 14 x 14
   corners); find_chessboard_corners on the card, against the CPU on
   frames 0-11 (the same images found, the same levels, corners to 1e-9
   px); at least 3/4 of the images yield the full grid and the corners'
   rms against the true projections is at most 0.15 px; an in-memory
   corners.vnl read by compute_chessboard_corners; seed_stereographic
   (focal 700) on the card against the CPU (1e-9), its batched PnP
   launching cholesky_factor_solve at (Nobs, 6, 1) 20 times per pass;
   the staged solves of tests/test_seeding.py (geometry only, then
   OPENCV8 in full from zero distortions; no outlier rejection), one
   fused launch and one back-substitution per iteration at the frames
   kept; the stage-2 rms no larger than the same objective at the true
   geometry (+1e-9), fx, fy, cx, cy within 1 px and camera 1's
   translation within 2 mm of the truth; cameramodels and camera 0's
   valid-intrinsics region (contourpy, else the bounding box: the log
   says which); each stage's wall; and, no gate, find_chessboard_corners
   on one 6000 x 4000 render of a board.
   dense_stereo: the library half of mrcal-stereo on
   stereo_opencv8_2cam's true models (two OPENCV8 cameras of 800 x 600,
   0.22 m apart): the pair rendered on the card (4 x 4 supersamples of a
   textured plane 2.4-4.0 m away, tilted in depth, and a textured box at
   1.45-1.75 m), rectified_system (LATLON, 50 x 40 degrees, the
   cameras' own resolution: 655 x 521), rectification_maps and
   transform_image of both 8-bit images; census + SGM (disparity
   0-127, its stages timed apart), stereo_range and stereo_unproject of
   its disparity, stereo_matching_ncc (block 9) on the same pair;
   match_feature of 50 seeded features of camera 0 in camera 1 (the
   estimate within 3 px of the truth); mrcal-reproject-image's flow
   (camera 0 to its corner-fit pinhole, then from a copy with a
   valid-intrinsics region, masked).  Each against the CPU in the same
   process: the maps (and the reprojection's) to 2 float32 ulps, the
   images equal but for 0.1 % of the pixels by one level, census, cost
   volume, aggregation and SGM disparity bit-equal, NCC the same
   disparity wherever the best score beats the second by 1e-5 (0.1 % of
   the pixels otherwise), ranging to 1e-12, matches to 1e-9 px.  The
   SGM disparity against the true geometry on the plane's and the box's
   interiors (tests/test_stereo_sgm.py's gates), and its range (median
   relative error below 0.02).  Then a synthetic rectified 1920 x 1080
   pair (a plane whose disparity ramps from 40 to 160 px, a box at 230)
   by SGM with disparity 0-255 on the card alone: its wall, its peak
   memory and the same truth gates.  No batched-Cholesky kernel may
   launch.  Each stage's warm wall on the card beside the CPU's.
   tools: the port's command-line tools (mrcal_tpu_torch.tools), each
   on the card as a user runs it (main(argv), no device) and held to the
   same call with device="cpu": mrcal-calibrate-cameras on
   calibrate_from_images' detections (a corners.vnl in a temporary
   directory, named so that the globs *-cam0.png and *-cam1.png split
   the cameras; LENSMODEL_OPENCV8, focal 700, 800 x 600, the 14 x 14
   board, --valid-intrinsics-region) into two .cameramodel files: the
   same Noutliers, the rms within 1e-8 px, each model's projection of a
   30 x 22 grid within 1e-6 px, camera 1's extrinsics within 1e-9; fx,
   fy, cx, cy within 1 px and camera 1's t within 2 mm of the truth; one
   fused launch and one back-substitution per iteration in every solve
   of the tool.  On the written models: mrcal-reoptimize (and
   profiling.timings() after its solve), mrcal-convert-lensmodel to
   LENSMODEL_OPENCV4 by re-solve and by --sampled (no kernel launch),
   mrcal-report-fov, -reproject-points and
   -is-within-valid-intrinsics-region, and mrcal-triangulate of a pixel
   pair with both noises (its report's numbers within 1e-9 relative).
   Then mrcal-stereo's array function on dense_stereo's rendered pair
   (SGM, disparities 0-127, the range image and the point cloud): the
   rectified images as dense_stereo gates them, the card's disparity
   bit-equal to the CPU's on the card's rectified pair, ranges 1e-12,
   the SGM gates against the truth; and mrcal-reproject-image's to
   camera 0's corner-fit pinhole (the map within 2 float32 ulps, the
   images as dense_stereo gates them).  Each tool's wall on the card and
   on the CPU; the tools' kernel shapes join the kernel checks and
   times.
   visualization: the data half of every plot of
   mrcal_tpu_torch.visualization and the mrcal-show-* tools, at the
   tools' default grids, for tools' two calibrated cameras (OPENCV8, 83
   frames of the 14 x 14 board, 800 x 600, with their optimization_inputs
   and valid-intrinsics regions) and for splined_30x18's solved model: the
   projection difference of the two at infinity (60 x 45), camera 0's
   projection uncertainty (30 x 22, mean-pcam, worstdirection-stdev and
   rms-stdev) and against distance (40 ranges along the observations'
   centroid), its distortion off pinhole (60 x 45) and radial profile,
   its resolution (40 wide), both cameras' board residuals (the
   vectorfield, magnitudes, directions, regional means, histogram samples
   and the worst observation's field), the geometry (the cameras and the
   83 boards in the plot frame), the stereo-pair difference of the pair
   against itself with camera 1 yawed by 1 mrad (the library's, and
   mrcal-show-stereo-pair-diff's rect0 difference), and splined_30x18's
   deltau over 60 x 45 (held where the grid's unprojection converges, the
   same pixels on both; off the observed region the solved spline has no
   inverse).  Each on the card (timed warm) and on the CPU,
   held card against CPU: difflen, projections and deltau 1e-8 px,
   uncertainties 1e-7 relative, residuals 1e-12 of the largest (or of
   1 px, if the largest is smaller), the
   resolution 1e-8 relative, poses 1e-12 m.  No batched-Cholesky kernel
   may launch, and nothing is drawn (no matplotlib import).
   sfm_points: SfM with the points in the state (problems.sfm_points,
   mrcal's test-sfm-fixed-points): camera 0 of stereo_opencv8_2cam flies
   make_tracks' default track, 398 frames over 15,000 ground features
   (the last 4 fixed), 0.3 px of noise; 120000 measurements, 47370 states.
   Warm-up, then a timed f64 solve: the point blocks' fused solve at
   (14996, 3, 2385) and their back-substitution at (14996, 3, 1) once per
   iteration, no other launch; the rms within 3 % of the noise's
   prediction, 0.3 sqrt(1 - Nstate / Nmeasurements); the variable points'
   and the translations' errors against the truth, the peak memory and
   the two halves' ms printed.  Then sfm_points_20k (20000 observations:
   134 frames, 5000 points; 40000 measurements, 15786 states) solved on
   the card and on the CPU from the same inputs: the card's rms held to
   the JAX package's f64 result, 0.2343302348497757 px +- 1e-8, in 40 +-
   10 iterations, b_packed to the CPU's within 1e-5, the launches at (4996,
   3, 801) and (4996, 3, 1), and optimizer_callback (J with the point
   columns) card against CPU at 1e-12.
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
   splined x8: 8 splined_30x18 units (unit 0 the splined phase's problem,
   unit i >= 1 perturbed_oi(seed=1+i) with 0.2 px of board noise) through
   the batched spline-window assembly: unit 0 held to splined_30x18's
   gates; one fused launch at (672, 6, 1083) and one back-substitution at
   (672, 6, 1) per lockstep iteration; units 0, 1 and 7 against their own
   optimize() in E over ten iterations (1e-10) and at the end of their
   tails (ftol 1e-10: 1e-9), with b_packed, the residuals and the reduced
   system's condition number printed (see TRAJECTORY_KW); a mixed batch
   (the f32 phase's lazy Hessian per unit), unit 0 held to +- 1e-5 px.
   Each prints its wall, lockstep and per-unit iterations, problems per
   second, ms per lockstep iteration, the peak memory and P times the
   single solve's wall.
8. kernel times: each kernel at the shapes of phase 3 in f64 (CUDA
   events, and device time per launch from torch.profiler) beside its
   plain version, the PyTorch library call and its bound, and beside the
   launch floor (a one-element torch.add).
9. profile: the first 8 iterations of one more f64 solve of each
   configuration, and of the fleet and the splined fleet, under
   torch.profiler (device time by kernel, launches per iteration,
   busy share); one SGM call on dense_stereo's rectified pair and one on
   its 2-MP pair (device kernels, busy share, the top device ops).
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
# cahvor_1cam and cahvore_1cam: the JAX package's converged f64 rms and
# iterations on the CPU (PERF.md section 2 gives the command)
CAHVOR_F64_RMS = 0.29588193204700636
CAHVOR_NITER_RANGE = (32 - 3, 32 + 3)
CAHVORE_F64_RMS = 0.2958303685900879
CAHVORE_NITER_RANGE = (6 - 3, 6 + 3)
CAHVOR_F64_RMS_TOL = 1e-6
# the [cahvor] phase's grid of project/unproject (mrcal-show-projection-
# diff's default, 60 x 45), card against CPU in pixels
CAHVOR_GRID = (60, 45)
CAHVOR_GRID_PX_TOL = 1e-8
# and their gradients, relative to the largest entry
CAHVOR_GRID_GRADIENT_RTOL = 1e-10
# optimizer_callback on the card against the CPU: x and J to this much of
# their largest entry
CALLBACK_REL_TOL = 1e-12
# check_gradient's worst relative error, card against CPU: the finite
# differences' roundoff, eps |x| / FD_STEP, is ~2e-11 of a pixel here
CHECK_GRADIENT_ABS_TOL = 1e-10
# the two-view wrappers, rotate_point_R and unproject_core on the card
# against the CPU, to this much of each output's largest entry
TRIANGULATE_REL_TOL = 1e-12
# stereo_opencv8_2cam: the JAX package's converged f64 rms and iterations
# on the CPU (tests/jax_target_stereo_opencv8_2cam.py; PERF.md section 2).
# The card's trajectory is the JAX package's through iteration 12; from
# iteration 13 on (steps of 1.4e-6 and less) the predicted decrease is
# below E's roundoff, and where the LM rules stop follows it: the JAX
# package stops after 15 iterations, the port after 20 on the card's host
# CPU and STEREO_NITER_CARD on the card, all at the same rms to 1e-15 (PERF.md
# section 6; the phase prints the tail of both trajectories).  So the
# solve is held to reach the rms within 15 + 3 iterations (a solve capped
# there), and to take 15 - 3 to STEREO_NITER_CARD + 3
STEREO_F64_RMS = 0.29857396040360784
STEREO_F64_RMS_TOL = 1e-6
STEREO_NITER = 15
STEREO_NITER_CARD = 21
# the LM iterations from which the phase prints the trajectories of the
# card and the CPU
STEREO_TAIL_FROM = 11
# its problem built on the card against the CPU (px)
STEREO_BUILD_PX_TOL = 1e-9
# triangulate() on the card against the CPU: the points (m), the
# covariances to this much of their largest entry (projection_uncertainty's
# gate), and the dense pairs' points relative to each point's range
STEREO_FEATURES = 500
# dp/db in either mode of torch.func is timed at STEREO_FEATURES points and
# at the first this many (a handful, as mrcal-triangulate gives)
STEREO_FEW = 5
STEREO_P_TOL = 1e-9
STEREO_COV_TOL = 1e-7
STEREO_DENSE_RTOL = 1e-10
# the dense pairs: every pixel of camera 0 on a plane this far from it
# (m), tilted by this much about camera 0's y axis
STEREO_PLANE = (2.0, 20.0)
# sfm_points (problems.SFM_POINTS): the JAX package's converged f64 rms on
# the CPU (tests/jax_target_sfm_points.py --full: 64 iterations, a 552.6 s
# solve and a 4.95 GB peak resident set on an 8-core Intel Xeon), held to
# 1e-8 px, and the iterations within 10 of the JAX package's 64; the
# noise's prediction, noise_px sqrt(1 - Nstate / Nmeasurements), is
# printed beside them
SFM_POINTS_SHAPE = (120000, 47370)
SFM_POINTS_F64_RMS = 0.23389657841660424
SFM_POINTS_RMS_TOL = 1e-8
SFM_POINTS_NITER_RANGE = (64 - 10, 64 + 10)
# sfm_points_20k (problems.SFM_POINTS_20K): the JAX package's converged
# f64 rms on the CPU (tests/jax_target_sfm_points.py; 40 iterations), held
# to 1e-8 px; the card against the CPU: b_packed (packed units), and the
# iterations within 10 of the JAX package's 40 (the port on the CPU takes
# 43: the solve reaches the optimum in ~29, and the count of the rejected
# roundoff steps after it follows the summation order)
SFM_POINTS_20K_SHAPE = (40000, 15786)
SFM_POINTS_20K_F64_RMS = 0.2343302348497757
SFM_POINTS_20K_RMS_TOL = 1e-8
SFM_POINTS_20K_B_ATOL = 1e-5
SFM_POINTS_20K_NITER_RANGE = (40 - 10, 40 + 10)

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
# the splined fleet: 8 wide-angle units of one rig design, units 0, 1 and
# 7 held to their own optimize()
SPLINED_FLEET_P = 8
SPLINED_FLEET_CHECKED_UNITS = (0, 1, 7)
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
# The splined fleet's knots are resolved only to the normal equations'
# conditioning: on the card unit 0 alone and in the batch took the same
# 208 iterations to E 4.3e-13 apart and 7.4e-5 apart in its knots (1.9e-6
# px in the residuals), and unit 7 after ten iterations was 4.6e-13 apart
# in E and 2.0e-8 in b_packed (PERF.md).  So its units are held to their
# own optimize() in E, over their first ten iterations and at the end of
# their tails; b_packed (knots, and poses with the warp), the residuals
# and the reduced system's condition number are printed
TRAJECTORY_KW = dict(SOLVE_KW, max_iterations=10)
BATCH_TRAJ_E_RTOL = 1e-10
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
# the profiled window: each configuration's first 8 iterations (every
# iteration does the same work; whole solves under the profiler took 448 s
# of the script's 698 on the card, and 16 iterations of each 235 s of 796,
# most of it the profiler's post-processing on the host, PERF.md)
PROFILE_ITERATIONS = 8


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
SPLINED_FLEET_SHAPES = [(SPLINED_FLEET_P * 84, 6, 1083),
                        (SPLINED_FLEET_P * 84, 6, 1)]
# CAHVOR: 9 intrinsics and the warp, K = 9 + 2 + 1; CAHVORE: 12 + 2 + 1,
# the main path's K = 15
CAHVOR_SHAPES = [(84, 6, 12)]
# stereo_opencv8_2cam: 2*12 intrinsics, 6 extrinsics and the warp, K = 33
STEREO_SHAPES = [(84, 6, 33)]
# sfm_points: the point blocks, (Npoints_variable, 3, Nc + 1) fused and
# (Npoints_variable, 3, 1) back-substituted; Nc = 6 (Nframes - 1) + 2, the
# camera block's two warp slots being always allocated (zero here), as in
# the JAX package
SFM_POINTS_SHAPES = [(14996, 3, 2385), (14996, 3, 1)]
SFM_POINTS_20K_SHAPES = [(4996, 3, 801), (4996, 3, 1)]
LARGE_SHAPES = [(1 << 20, 3, 4), (1 << 18, 6, 15), (1 << 20, 3, 1),
                (1 << 18, 6, 1)]
CHECK_SHAPES = (MAIN_SHAPES + CAM4_SHAPES + RIG16_SHAPES + SPLINED_SHAPES
                + ODD_SHAPES + FLEET_SHAPES + RIG16_BATCH_SHAPES
                + SPLINED_FLEET_SHAPES + CAHVOR_SHAPES + STEREO_SHAPES
                + SFM_POINTS_SHAPES + SFM_POINTS_20K_SHAPES
                + [(131, 6, 33), (131, 3, 4), (0, 6, 15), (70000, 6, 0)]
                + LARGE_SHAPES)


def check_fused(torch, rng):
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    dev = torch.device("cuda")
    check_fused_at(torch, rng, CHECK_SHAPES)

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


def check_fused_at(torch, rng, shapes):
    """The fused kernel and the solve against their plain versions at each
    (B, n, K) of shapes, f64 and f32."""
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    dev = torch.device("cuda")
    tol = {torch.float64: 1e-12, torch.float32: 1e-5}
    for dt in (torch.float64, torch.float32):
        for B, n, K in shapes:
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


def time_kernels(torch, card, extra_shapes=None):
    """Each wrapper at its shapes (and at extra_shapes: wrapper -> (B, n,
    K) list), f64: CUDA-event ms per call, device us per launch, plain and
    library ms, bound and share; and the launch floor."""
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
                               + SPLINED_FLEET_SHAPES[:1] + CAHVOR_SHAPES
                               + STEREO_SHAPES + SFM_POINTS_SHAPES[:1]
                               + SFM_POINTS_20K_SHAPES[:1] + LARGE_SHAPES),
        cholesky_solve_factored=(MAIN_SHAPES + CAM4_SHAPES + RIG16_SHAPES
                                 + ODD_SHAPES[1:] + FLEET_SHAPES
                                 + RIG16_BATCH_SHAPES
                                 + SPLINED_FLEET_SHAPES[1:]
                                 + SFM_POINTS_SHAPES[1:]
                                 + SFM_POINTS_20K_SHAPES[1:] + LARGE_SHAPES),
        cholesky_factor=[(84, 6, 0), (1 << 20, 3, 0), (1 << 18, 6, 0)])
    for name, more in (extra_shapes or {}).items():
        shapes[name] += [sh for sh in more if sh not in shapes[name]]
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
                launches_per_iteration=True, kernel_shapes=None, solved=None):
    """A bench configuration in f64: a warm-up solve, then a timed solve
    with the kernels' launch counts and its peak memory, held to the JAX
    package's rms (and iteration count), and its two halves timed apart.
    kernel_shapes: the (B, n, K) of the fused launch and of the
    back-substitution, asserted for every launch of the timed solve.
    solved(oi_solved) -> a dict of more summary entries."""
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
    torch.cuda.reset_peak_memory_stats()
    bc.reset_launches()
    with KernelShapes() as ks:
        t0 = time.perf_counter()
        stats = optimize(precision="f64", **SOLVE_KW, **oi_f64)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = dict(bc.launches)
    rms = stats["rms_reproj_error__pixels"]
    niter = stats["niterations"]
    log(f"[{phase}] f64: rms {rms!r} px in {niter} iterations, "
        f"{wall:.4f} s wall, {wall / niter * 1e3:.3f} ms/iteration, "
        f"peak memory {peak / 2**30:.3f} GiB, "
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
    if kernel_shapes is not None:
        check_kernel_shapes(phase, ks.shapes, kernel_shapes)
    more = solved(oi_f64) if solved else {}
    halves = time_halves(torch, phase, oi_f64, stats)
    return oi, dict(rms=rms, niterations=niter, wall_s=wall,
                    ms_per_iteration=wall / niter * 1e3, launches=launches,
                    peak_bytes=peak, **halves, **more)


def check_kernel_shapes(phase, shapes, want):
    """Every fused launch at want[0] and every back-substitution at
    want[1], as KernelShapes recorded them."""
    for name, sh in zip(KernelShapes.NAMES, want):
        if set(shapes[name]) != {tuple(sh)}:
            fail(f"[{phase}] {name} ran at {sorted(set(shapes[name]))}, "
                 f"not {tuple(sh)}")


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


def grid_project_unproject(torch, phase, model):
    """unproject (with gradients) of the 60 x 45 grid over the model's
    imager, and project (with gradients) of the CPU's unprojection, on
    the card against the CPU: each in pixels (an unprojection by where
    the CPU projects it), the gradients relative to their largest
    entry."""
    from mrcal_tpu_torch import project, sample_imager, unproject
    lens, intr = model.intrinsics()
    q = sample_imager(*CAHVOR_GRID, *model.imagersize(), device="cpu")
    u_g, wall = _sync_time(torch, lambda: unproject(q, lens, intr,
                                                   get_gradients=True))
    u_c = unproject(q, lens, intr, get_gradients=True, device="cpu")
    p_g = project(u_c[0], lens, intr, get_gradients=True)
    p_c = project(u_c[0], lens, intr, get_gradients=True, device="cpu")
    if not all(t.device.type == "cuda" and torch.isfinite(t).all()
               for t in tuple(u_g) + tuple(p_g)):
        fail(f"[{phase}] project/unproject: not finite on the card")

    def px(v):
        return project(v, lens, intr, device="cpu")
    out = dict(
        unproject_px=float((px(u_g[0].cpu()) - px(u_c[0])).abs().max()),
        project_px=float((p_g[0].cpu() - p_c[0]).abs().max()),
        gradients_rel=max(rel_err(g.cpu(), c) for g, c in
                          zip(tuple(u_g[1:]) + tuple(p_g[1:]),
                              tuple(u_c[1:]) + tuple(p_c[1:]))),
        roundtrip_px=float((px(u_c[0]) - q).abs().max()),
        unproject_card_s=wall)
    log(f"[{phase}] {lens} over the {CAHVOR_GRID[0]} x {CAHVOR_GRID[1]} "
        f"grid (unproject with gradients on the card {wall * 1e3:.1f} ms), "
        f"card vs CPU: unproject {out['unproject_px']:.3e} px, "
        f"project {out['project_px']:.3e} px (tol "
        f"{CAHVOR_GRID_PX_TOL:g}), gradients {out['gradients_rel']:.3e} of "
        f"the largest entry (tol {CAHVOR_GRID_GRADIENT_RTOL:g}); CPU round "
        f"trip {out['roundtrip_px']:.3e} px")
    if not (out["unproject_px"] <= CAHVOR_GRID_PX_TOL
            and out["project_px"] <= CAHVOR_GRID_PX_TOL
            and out["gradients_rel"] <= CAHVOR_GRID_GRADIENT_RTOL):
        fail(f"[{phase}] project/unproject: the card and the CPU disagree")
    return out


def phase_cahvor(torch, phase):
    """cahvor_1cam or cahvore_1cam in f64, held to the JAX package's rms
    and iterations, with the fused kernel at K = 12 (CAHVOR) or 15
    (CAHVORE) and one back-substitution per iteration; then a solve's
    cameramodel: project/unproject over the grid, and on cahvor_1cam
    projection_uncertainty (mean-pcam at 1 m on the 30 x 22 grid), card
    against CPU."""
    from mrcal_tpu_torch import cameramodel, problems, sample_imager, unproject
    from mrcal_tpu_torch.optimize import spec_from_inputs
    cahvor = phase == "cahvor_1cam"
    oi, f64 = timed_solve(
        torch, phase, problems.perturbed_oi(getattr(problems, phase)(),
                                            seed=1),
        (32935, 515) if cahvor else (32938, 518),
        CAHVOR_F64_RMS if cahvor else CAHVORE_F64_RMS, CAHVOR_F64_RMS_TOL,
        CAHVOR_NITER_RANGE if cahvor else CAHVORE_NITER_RANGE)
    K = (CAHVOR_SHAPES if cahvor else MAIN_SHAPES)[0][2]
    with KernelShapes() as ks:
        solved = _solved(oi)
    shapes = {k: sorted(set(v)) for k, v in ks.shapes.items()}
    log(f"[{phase}] the kernels ran at {shapes}")
    if f64["fused_K"] != K or shapes != {
            "cholesky_factor_solve": [(84, 6, K)],
            "cholesky_solve_factored": [(84, 6, 1)]}:
        fail(f"[{phase}] the kernels ran at {shapes}, K {f64['fused_K']}")
    model = cameramodel(optimization_inputs=solved, icam_intrinsics=0)
    f64["grid"] = grid_project_unproject(torch, phase, model)
    if cahvor:
        v = unproject(sample_imager(UNC_GRID, None, *model.imagersize()),
                      *model.intrinsics(), normalize=True)
        f64["uncertainty"] = uncertainty_call(
            torch, phase, model, v, spec_from_inputs(**solved).Nstate,
            "mean-pcam", False, "covariance")
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


def splined_condition(torch, oi, b_packed):
    """The condition number of a splined problem's reduced camera system
    (Hcc less the frames' Schur complement, undamped) at b_packed: how
    far roundoff in the normal equations moves the knots."""
    from mrcal_tpu_torch.convert import from_reference
    from mrcal_tpu_torch.optimize.solver import build_normal_equations
    spec, arrays, b = from_reference(oi, b_packed, device="cuda")
    static_idx = dict(board=oi["indices_frame_camintrinsics_camextrinsics"],
                      point=np.zeros((0, 3), np.int64))
    with torch.no_grad():
        ne = build_normal_equations(spec, arrays, static_idx)(b, arrays)
        Nf = spec.Nframes
        Cf = ne["Cf"][:Nf]
        H = ne["Hcc"] - torch.einsum("fic,fid->cd", Cf, torch.linalg.solve(
            ne["Hff"][:Nf], Cf))
        eig = torch.linalg.eigvalsh(H)
    return float(eig[-1] / eig[0])


def phase_batch_splined(torch, single_wall):
    """8 splined_30x18 units in lockstep through the batched spline-window
    assembly: the frame blocks at (672, 6, 1083), units 0, 1 and 7 held
    to their own optimize(), and a mixed batch (lazy-H per problem)."""
    from mrcal_tpu_torch import optimize, problems
    from mrcal_tpu_torch.optimize import spec_from_inputs
    from mrcal_tpu_torch.optimize.solver import _lazy_h_K
    phase = "batch splined x8"
    units = batch_units(problems.splined_30x18(), SPLINED_FLEET_P,
                        FLEET_NOISE_PX)
    spec = spec_from_inputs(**units[0])
    if (spec.Nmeasurements, spec.Nstate) != (34008, 1586):
        fail(f"[{phase}] the units have the wrong shape")
    _, stats, summary = timed_batch(torch, phase, units, single_wall)
    check_batch_launches(phase, summary, SPLINED_FLEET_SHAPES)
    check_unit0(phase, stats, SPLINED_F64_RMS, SPLINED_F64_RMS_TOL,
                SPLINED_NITER_RANGE)

    # the batch against units solved alone: their first ten iterations,
    # and to the end of their tails
    nint = spec.num_states_intrinsics
    _, stats10, _ = timed_batch(torch, phase, units, single_wall,
                                solve_kw=TRAJECTORY_KW)
    _, stats_deep, deep = timed_batch(torch, phase, units, single_wall,
                                      solve_kw=DEEP_KW)
    alone = {}
    for i in SPLINED_FLEET_CHECKED_UNITS:
        s10 = optimize(precision="f64", **TRAJECTORY_KW, **_copy(units[i]))
        s = optimize(precision="f64", **DEEP_KW, **_copy(units[i]))
        a = alone[i] = dict(
            E_rel_10=abs(_E(stats10[i]) - _E(s10)) / _E(s10),
            E_rel=abs(_E(stats_deep[i]) - _E(s)) / _E(s),
            niterations=s["niterations"],
            niterations_batch=stats_deep[i]["niterations"])
        for tag, x, y in (("_10", stats10[i], s10), ("", stats_deep[i], s)):
            d_b = np.abs(x["b_packed"] - y["b_packed"])
            a.update({f"b_knots{tag}": float(d_b[:nint].max()),
                      f"b_poses{tag}": float(d_b[nint:].max()),
                      f"x_px{tag}": float(np.abs(x["x"] - y["x"]).max())})
        log(f"[{phase}] unit {i} alone: 10 iterations E rel diff "
            f"{a['E_rel_10']:.3e} (tol {BATCH_TRAJ_E_RTOL:g}); ftol 1e-10: "
            f"{s['niterations']} iterations (batch "
            f"{stats_deep[i]['niterations']}), E rel diff {a['E_rel']:.3e} "
            f"(tol {BATCH_E_RTOL:g}); printed, at 10 iterations and at the "
            f"end: b_packed knots {a['b_knots_10']:.3e}, {a['b_knots']:.3e}, "
            f"poses and warp {a['b_poses_10']:.3e}, {a['b_poses']:.3e}, "
            f"residuals {a['x_px_10']:.3e}, {a['x_px']:.3e} px")
        if not (a["E_rel_10"] <= BATCH_TRAJ_E_RTOL
                and a["E_rel"] <= BATCH_E_RTOL):
            fail(f"[{phase}] unit {i}: the batch and optimize() disagree")
    summary["reduced_system_condition_unit0"] = splined_condition(
        torch, units[0], stats_deep[0]["b_packed"])
    log(f"[{phase}] unit 0 at its end: the reduced camera system (the knots "
        f"and the warp, Schur-reduced, undamped) has condition number "
        f"{summary['reduced_system_condition_unit0']:.3e}")

    # mixed: the f32 phase with the lazy Hessian, each unit its own refresh
    lazy_K = _lazy_h_K(spec, torch.float32, torch.device("cuda"))
    _, stats_mx, mixed = timed_batch(torch, phase, units, single_wall,
                                     precision="mixed")
    rms0 = stats_mx[0]["rms_reproj_error__pixels"]
    diffs = [a["rms_reproj_error__pixels"] - b["rms_reproj_error__pixels"]
             for a, b in zip(stats_mx, stats)]
    log(f"[{phase}] mixed (lazy-H K = {lazy_K}): unit 0 rms {rms0!r} px "
        f"(gate {SPLINED_F64_RMS!r} +- {SPLINED_MIXED_RMS_TOL:g}); units' "
        f"rms minus f64 rms {', '.join(f'{d:+.2e}' for d in diffs)} px")
    if lazy_K != 4 or not abs(rms0 - SPLINED_F64_RMS) <= SPLINED_MIXED_RMS_TOL:
        fail(f"[{phase}] mixed unit 0 rms {rms0!r} (lazy K {lazy_K})")
    mixed.update(lazy_K=lazy_K, rms_diff_from_f64=diffs)
    summary.update(deep_ftol_1e_10=deep, alone=alone, mixed=mixed)
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
    infinity and at 1 m.  Each against the same call on the CPU.  Returns
    the summary and splined_30x18's solved cameramodel."""
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

    solved, models = {}, {}
    for name, oi, icam in (("opencv8_1cam", oi_main, 0),
                           ("opencv8_4cam", oi_4cam, 2),
                           ("splined_30x18", oi_splined, 0)):
        solved[name] = _solved(oi)
        model = cameramodel(optimization_inputs=solved[name],
                            icam_intrinsics=icam)
        models[name] = model
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
                conditioning=conditioning, wall_s=wall), \
        models["splined_30x18"]


def stereo_features(torch, models, rng, n):
    """n features seen by both cameras: pixels of camera 0 drawn from rng
    at ranges of 1-10 m, kept where camera 1 sees them too, projected by
    the models, with 0.3 px of noise from rng: q (n, 2 cameras, 2), on
    the CPU."""
    from mrcal_tpu_torch import (compose_rt, invert_rt, project,
                                 transform_point_rt, unproject)
    m0, m1 = models
    W, H = m0.imagersize()
    rt10 = compose_rt(m1.rt_cam_ref(), invert_rt(m0.rt_cam_ref(),
                                                 device="cpu"), device="cpu")
    q0, q1 = np.zeros((0, 2)), np.zeros((0, 2))
    while len(q0) < n:
        q = rng.uniform(0, 1, (4 * n, 2)) * [W - 1, H - 1]
        p0 = unproject(q, *m0.intrinsics(), normalize=True, device="cpu") \
            * torch.as_tensor(rng.uniform(1.0, 10.0, (4 * n, 1)))
        p1 = transform_point_rt(rt10, p0, device="cpu")
        q_1 = project(p1, *m1.intrinsics(), device="cpu").numpy()
        seen = ((p1[:, 2] > 0).numpy() & (q_1[:, 0] >= 0)
                & (q_1[:, 0] <= W - 1) & (q_1[:, 1] >= 0)
                & (q_1[:, 1] <= H - 1))
        q0 = np.concatenate([q0, q[seen]])
        q1 = np.concatenate([q1, q_1[seen]])
    q = np.stack([q0[:n], q1[:n]], axis=-2)
    return q + rng.normal(0.0, 0.3, q.shape)


def stereo_dense(torch, models):
    """Every pixel of camera 0 (q0), and q1: where camera 1 sees the
    point of a plane STEREO_PLANE[0] m from camera 0, tilted by
    STEREO_PLANE[1] degrees about its y axis, that q0 sees.  Made on the
    card, returned on the CPU: (W*H, 2 cameras, 2)."""
    from mrcal_tpu_torch import (compose_rt, invert_rt, project,
                                 sample_imager, transform_point_rt,
                                 unproject)
    m0, m1 = models
    W, H = m0.imagersize()
    q0 = sample_imager(W, H, W, H).reshape(-1, 2)    # every pixel
    v0 = unproject(q0, *m0.intrinsics())
    d, tilt = STEREO_PLANE[0], np.radians(STEREO_PLANE[1])
    n = torch.tensor([np.sin(tilt), 0.0, np.cos(tilt)], dtype=v0.dtype,
                     device=v0.device)
    p0 = v0 * (d / (v0 @ n))[:, None]
    rt10 = compose_rt(m1.rt_cam_ref(), invert_rt(m0.rt_cam_ref()))
    q1 = project(transform_point_rt(rt10, p0), *m1.intrinsics())
    return torch.stack([q0, q1], dim=-2).cpu()


def lm_tails(torch, phase, oi):
    """oi's f64 solve traced from LM iteration STEREO_TAIL_FROM on, twice
    on the card and once on the CPU: each iteration's E, its trial's
    E_try - E as computed, the predicted decrease, lambda and the largest
    step (read where the verbose solve prints its line); and the
    roundoff of E = sum x^2 at the solution, as each device sums it,
    against math.fsum.  Logs them and returns them."""
    import math
    from mrcal_tpu_torch import optimize
    from mrcal_tpu_torch.optimize import solver

    def trace(device):
        rows = []

        def record(it, E, E_try, pred, lam, db):
            if it >= STEREO_TAIL_FROM:
                rows.append([it] + torch.stack(
                    [E, E_try - E, pred, lam, db.abs().max()]).tolist())
        printer, solver._print_iteration = solver._print_iteration, record
        try:
            stats = optimize(precision="f64", verbose=True, device=device,
                             **dict(SOLVE_KW, **_copy(oi)))
        finally:
            solver._print_iteration = printer
        x = np.asarray(stats["x"], np.float64)
        exact = math.fsum(x * x)
        roundoff = {d: float(torch.sum(torch.as_tensor(x, device=d) ** 2))
                    - exact for d in ("cuda", "cpu")}
        return dict(niterations=stats["niterations"], rows=rows,
                    E_roundoff=roundoff)

    tails = {}
    for label, device in (("card 1", "cuda"), ("card 2", "cuda"),
                          ("CPU", "cpu")):
        t = tails[label] = trace(device)
        log(f"[{phase}] LM tail, {label}: {t['niterations']} iterations; "
            f"at the solution sum x^2 - fsum: card "
            f"{t['E_roundoff']['cuda']:.3e}, CPU "
            f"{t['E_roundoff']['cpu']:.3e}")
        for it, E, dE, pred, lam, db in t["rows"]:
            log(f"[{phase}]   {label} iteration {it}: E {E!r} E_try - E "
                f"{dE:.3e} pred {pred:.3e} lambda {lam:.3e} |db| {db:.3e} "
                f"{'accepted' if dE < 0 else 'rejected'}")
    return tails


def triangulate_split(torch, q, models, kw):
    """One triangulate() call with both noises on the card, stage by
    stage as it runs them: the unprojections, their linearizations,
    Var_obs, J (the solve's upload, its Jacobian's triplets and the dense
    J), the factor (JtJ's, from J's QR), dp/db and the propagation (the
    solve, Jobs A and its product), seconds each.  Then dp/db in forward
    and in reverse mode of torch.func, warm, at these points and at the
    first STEREO_FEW, with the peak memory of each at all the points."""
    from mrcal_tpu_torch import model_analysis as ma
    from mrcal_tpu_torch import triangulation as tri
    q2 = torch.as_tensor(q, device="cuda").reshape(-1, 2, 2)
    core = tri._leecivera_mid2
    out = {}
    cams = [tri._model_tensors(m, q2.device) for m in models]
    v, out["unproject_s"] = _sync_time(torch, lambda: [
        tri.unproject_core(q2[:, i], intr, lm)
        for i, (lm, intr, _) in enumerate(cams)])
    lins, out["linearize_s"] = _sync_time(torch, lambda: [
        tri._linearization(q2[:, i], intr, lm, v[i])
        for i, (lm, intr, _) in enumerate(cams)])
    Rt01 = tri._compose_Rt2(cams[0][2], tri._invert_Rt(cams[1][2]))
    _, out["Var_obs_s"] = _sync_time(torch, lambda: tri._Var_observation(
        q2, cams, lins, Rt01, core, kw["q_observation_stdev"],
        kw["q_observation_stdev_correlation"]))
    prob, out["J_s"] = _sync_time(torch, lambda: ma._Solved(
        models[0].optimization_inputs(), q2.device))
    _, dt = _sync_time(torch, lambda: prob.J)
    out["J_s"] += dt
    _, out["factor_s"] = _sync_time(torch, lambda: prob.factorization)
    icams = tri._stationary_cameras(prob.kw, models)
    dp, out["dp_db_s"] = _sync_time(torch, lambda: tri._dp_db(
        prob, q2, icams, core, True, lins))
    _, out["propagate_s"] = _sync_time(torch, lambda: ma._propagate(
        prob, dp.reshape(dp.shape[0] * 3, -1), kw["q_calibration_stdev"]))

    modes = {}
    for n in (q2.shape[0], STEREO_FEW):
        qn = q2[:n]
        F = tri._dp_db_map(prob, qn, icams, core, True, [
            tri._linearization(qn[:, i], intr, lm)
            for i, (lm, intr, _) in enumerate(cams)])
        db0 = prob.b.new_zeros(prob.spec.Nstate)
        for name in ("jacfwd", "jacrev"):
            jac = getattr(torch.func, name)(F)
            jac(db0)
            torch.cuda.reset_peak_memory_stats()
            J, dt = _sync_time(torch, lambda: jac(db0))
            modes[f"{name} {n}"] = dict(
                ms=dt * 1e3, peak_bytes=torch.cuda.max_memory_allocated(),
                rel_err_vs_dp_db=rel_err(J[:n].cpu(), dp[:n].cpu()))
    out["modes"] = modes
    return out


def phase_stereo(torch):
    """stereo_opencv8_2cam: the problem built by synthetic_data on the card
    against the CPU; the f64 solve held to the JAX package's rms and
    iterations, the fused kernel at (84, 6, 33) and one back-substitution
    per iteration; then the solved models triangulate STEREO_FEATURES
    features with their calibration and observation uncertainty, and
    every pixel of camera 0 against a plane (the default method and
    Lindstrom's), each on the card against the CPU."""
    from mrcal_tpu_torch import (cameramodel, optimize, problems,
                                 triangulate, triangulate_lindstrom)
    phase = "stereo_opencv8_2cam"
    t_phase = time.perf_counter()
    oi, wall_build = _sync_time(torch, problems.stereo_opencv8_2cam)
    oi_cpu = problems.stereo_opencv8_2cam(device="cpu")
    build_px = float(np.abs(oi["observations_board"]
                            - oi_cpu["observations_board"]).max())
    same = all(np.array_equal(oi[k], oi_cpu[k]) for k in oi
               if k != "observations_board" and isinstance(oi[k],
                                                            np.ndarray))
    log(f"[{phase}] built on the card in {wall_build:.3f} s: "
        f"{len(oi['frames_rt_toref'])} frames; observations card vs CPU "
        f"{build_px:.3e} px (tol {STEREO_BUILD_PX_TOL:g}), the other arrays "
        f"{'equal' if same else 'DIFFERENT'}")
    if not (same and build_px <= STEREO_BUILD_PX_TOL):
        fail(f"[{phase}] the problem built on the card differs from the "
             "CPU's")

    oi, f64 = timed_solve(torch, phase, oi, (65876, 536), STEREO_F64_RMS,
                          STEREO_F64_RMS_TOL, (STEREO_NITER - 3,
                                               STEREO_NITER_CARD + 3))
    capped = optimize(precision="f64", **dict(
        SOLVE_KW, max_iterations=STEREO_NITER + 3), **_copy(oi))
    f64["rms_after_niter_plus_3"] = capped["rms_reproj_error__pixels"]
    log(f"[{phase}] f64 capped at {STEREO_NITER + 3} iterations: rms "
        f"{f64['rms_after_niter_plus_3']!r} px (tol {STEREO_F64_RMS_TOL:g})")
    if not abs(f64["rms_after_niter_plus_3"] - STEREO_F64_RMS) <= \
            STEREO_F64_RMS_TOL:
        fail(f"[{phase}] the solve does not reach the JAX package's rms in "
             f"{STEREO_NITER + 3} iterations")
    f64["tail"] = lm_tails(torch, phase, oi)
    with KernelShapes() as ks:
        solved = _solved(oi)
    shapes = {k: sorted(set(v)) for k, v in ks.shapes.items()}
    log(f"[{phase}] the kernels ran at {shapes}")
    B, n, K = STEREO_SHAPES[0]
    if f64["fused_K"] != K or shapes != {
            "cholesky_factor_solve": [(B, n, K)],
            "cholesky_solve_factored": [(B, n, 1)]}:
        fail(f"[{phase}] the kernels ran at {shapes}, K {f64['fused_K']}")
    models = [cameramodel(optimization_inputs=solved, icam_intrinsics=i)
              for i in (0, 1)]

    # features with their uncertainty
    q = stereo_features(torch, models, np.random.default_rng(5),
                        STEREO_FEATURES)
    kw = dict(q_calibration_stdev=0.3, q_observation_stdev=0.3,
              q_observation_stdev_correlation=0.1)
    triangulate(q, models, **kw)
    torch.cuda.reset_peak_memory_stats()
    got, wall = _sync_time(torch, lambda: triangulate(q, models, **kw))
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    want = triangulate(q, models, device="cpu", **kw)
    wall_cpu = time.perf_counter() - t0
    if not all(g.device.type == "cuda" and torch.isfinite(g).all()
               and g.shape == w.shape for g, w in zip(got, want)):
        fail(f"[{phase}] triangulate: not finite on the card in the CPU's "
             "shapes")
    got = [g.cpu() for g in got]
    err_p = float((got[0] - want[0]).abs().max())
    errs = [rel_err(g, w) for g, w in zip(got[1:], want[1:])]
    split = triangulate_split(torch, q, models, kw)
    # each point's own covariance, (N, 3, 3), and its worst direction
    blocks = torch.diagonal(want[3], dim1=0, dim2=2).permute(2, 0, 1)
    worst = float(torch.linalg.eigvalsh(blocks)[:, -1].sqrt().max())
    stages = ("unproject", "linearize", "Var_obs", "J", "factor", "dp_db",
              "propagate")
    rest = wall - sum(split[k + "_s"] for k in stages)
    log(f"[{phase}] triangulate {STEREO_FEATURES} features (Var_cal "
        f"{tuple(want[1].shape)}): card {wall * 1e3:.2f} ms warm ("
        + ", ".join(f"{k} {split[k + '_s'] * 1e3:.2f}" for k in stages)
        + f", the rest {rest * 1e3:.2f} ms), peak {peak / 2**30:.3f} GiB; "
        f"CPU {wall_cpu * 1e3:.1f} ms; card vs CPU: p {err_p:.3e} m (tol "
        f"{STEREO_P_TOL:g}), Var_cal {errs[0]:.3e}, Var_obs {errs[1]:.3e}, "
        f"Var_joint {errs[2]:.3e} of the largest entry (tol "
        f"{STEREO_COV_TOL:g}); depth {float(want[0][:, 2].min()):.2f}-"
        f"{float(want[0][:, 2].max()):.2f} m, worst stdev (joint) "
        f"{worst:.4f} m")
    for k, m in split["modes"].items():
        log(f"[{phase}] dp/db by torch.func.{k} points: {m['ms']:.2f} ms "
            f"warm, peak {m['peak_bytes'] / 2**30:.3f} GiB, against "
            f"_dp_db {m['rel_err_vs_dp_db']:.3e} of its largest entry")
    if max(m["rel_err_vs_dp_db"] for m in split["modes"].values()) > \
            STEREO_COV_TOL:
        fail(f"[{phase}] dp/db: the two modes of torch.func disagree")
    if not (err_p <= STEREO_P_TOL and all(e <= STEREO_COV_TOL
                                          for e in errs)):
        fail(f"[{phase}] triangulate: the card and the CPU disagree")
    features = dict(N=STEREO_FEATURES, wall_s=wall, wall_cpu_s=wall_cpu,
                    peak_bytes=peak, err_p_m=err_p, err_Var_cal=errs[0],
                    err_Var_obs=errs[1], err_Var_joint=errs[2],
                    worst_stdev_m=worst, rest_s=rest, **split)

    # every pixel of camera 0, p only
    qd = stereo_dense(torch, models)
    dense = {}
    for label, method in (("leecivera_mid2", None),
                          ("lindstrom", triangulate_lindstrom)):
        triangulate(qd, models, method=method)
        p_g, wall = _sync_time(torch, lambda: triangulate(qd, models,
                                                          method=method))
        t0 = time.perf_counter()
        p_c = triangulate(qd, models, method=method, device="cpu")
        wall_cpu = time.perf_counter() - t0
        rng_c = torch.linalg.vector_norm(p_c, dim=-1)
        err = float(((p_g.cpu() - p_c).abs().max(dim=-1).values
                     / rng_c.clamp_min(1e-300)).max())
        nzero = int((rng_c == 0).sum())
        log(f"[{phase}] triangulate {qd.shape[0]} pixel pairs ({label}): "
            f"card {wall * 1e3:.2f} ms, CPU {wall_cpu * 1e3:.1f} ms; card "
            f"vs CPU {err:.3e} of each point's range (tol "
            f"{STEREO_DENSE_RTOL:g}); {nzero} without a point; range "
            f"median {float(rng_c.median()):.4f} m")
        if not (p_g.device.type == "cuda" and torch.isfinite(p_g).all()
                and err <= STEREO_DENSE_RTOL):
            fail(f"[{phase}] dense triangulate ({label}): the card and the "
                 "CPU disagree")
        dense[label] = dict(N=qd.shape[0], wall_s=wall, wall_cpu_s=wall_cpu,
                            rel_err=err, without_point=nzero)
    f64.update(build_s=wall_build, build_px=build_px, features=features,
               dense=dense, wall_phase_s=time.perf_counter() - t_phase)
    log(f"[{phase}] phase {f64['wall_phase_s']:.1f} s")
    return oi, f64


# [calibrate_from_images]: stereo_opencv8_2cam's boards rendered into
# 8-bit images (CAL_SS x CAL_SS supersamples per pixel), detected, seeded
# (focal CAL_FOCAL) and solved in two stages
CAL_DEVICE = "cuda"
CAL_NFRAMES = 84
CAL_SS = 4
CAL_UNPROJECT_CHUNK = 1 << 21          # rays per unprojection call
CAL_RENDER_BATCH = 8                   # frames rendered at once
CAL_FOCAL = 700.0
CAL_CPU_FRAMES = 12                    # frames whose detection the CPU redoes
CAL_CORNER_PX_TOL = 1e-9               # card vs CPU
CAL_SEED_TOL = 1e-9                    # card vs CPU
CAL_CORNER_RMS_MAX = 0.15              # detections vs the truth (px)
CAL_FULL_SHARE_MIN = 0.75              # images that yield the full grid
CAL_RMS_SLACK = 1e-9
CAL_CORE_PX_TOL = 1.0
CAL_T1_TOL_M = 2e-3
CAL_PNP_STEPS = 20
CAL_LARGE = (6000, 4000)               # a 24-MP frame, timed only
CAL_STAGE1 = dict(do_optimize_intrinsics_core=False,
                  do_optimize_intrinsics_distortions=False,
                  do_optimize_calobject_warp=False)


def _cal_name(f, c):
    return f"frame{f:03d}-cam{c}.png"


def cal_rays(torch, truth, icam, dev):
    """The ray (unprojection, not normalized) of every supersample of
    camera icam's pixels, (Hpx * CAL_SS * Wpx * CAL_SS, 3), row-major;
    supersample (i, j) of pixel (x, y) at x + (j + 0.5) / CAL_SS - 0.5."""
    from mrcal_tpu_torch import unproject
    Wpx, Hpx = (int(v) for v in truth["imagersize"])
    f64 = torch.float64
    xs = (torch.arange(Wpx * CAL_SS, dtype=f64, device=dev) + 0.5) \
        / CAL_SS - 0.5
    ys = (torch.arange(Hpx * CAL_SS, dtype=f64, device=dev) + 0.5) \
        / CAL_SS - 0.5
    yy, xx = torch.meshgrid(ys, xs, indexing="ij")
    q = torch.stack([xx, yy], dim=-1).reshape(-1, 2)
    intr = truth["intrinsics"][icam]
    return torch.cat([unproject(q[i:i + CAL_UNPROJECT_CHUNK],
                                truth["lensmodel"], intr, device=dev)
                      for i in range(0, len(q), CAL_UNPROJECT_CHUNK)])


def cal_render(torch, truth, W, H, dev):
    """8-bit images (Nframes, 2, Hpx, Wpx) of the true boards: each
    supersample's ray meets the warped board (a few fixed-point steps on
    the warp's height), the board is a checkerboard of (W + 1) x (H + 1)
    squares whose inner vertices are the W x H corners (one border row of
    squares), dark 40, light 220, the background 130; the supersamples
    averaged and rounded."""
    from mrcal_tpu_torch.poseutils import _compose_Rt2, _Rt_from_rt
    Wpx, Hpx = (int(v) for v in truth["imagersize"])
    sp = float(truth["spacing"])
    kx, ky = (float(v) for v in truth["warp"])
    Rt_rb = torch.as_tensor(truth["Rt_ref_boardref"], device=dev)
    N = len(Rt_rb)
    out = torch.empty((N, 2, Hpx, Wpx), dtype=torch.uint8, device=dev)
    for c in range(2):
        v = cal_rays(torch, truth, c, dev)
        rt_cr = (np.zeros(6) if c == 0
                 else truth["extrinsics_rt_fromref"][c - 1])
        Rt_cr = _Rt_from_rt(torch.as_tensor(rt_cr, device=dev))
        for f0 in range(0, N, CAL_RENDER_BATCH):
            Rt = _compose_Rt2(Rt_cr, Rt_rb[f0:f0 + CAL_RENDER_BATCH])
            R, t = Rt[:, :3, :], Rt[:, 3, :]
            # board coordinate k of s v: s (e_k . v) - e_k . t, e_k the
            # board's axis k in the camera (R's column k)
            a = torch.einsum("nj,bjk->kbn", v, R)
            ct = torch.einsum("bj,bjk->kb", t, R)[..., None]
            h = torch.zeros_like(a[0])
            for _ in range(4):
                s = (h + ct[2]) / a[2]
                xb = s * a[0] - ct[0]
                yb = s * a[1] - ct[1]
                xr = xb / ((W - 1) * sp)
                yr = yb / ((H - 1) * sp)
                h = kx * 4 * xr * (1 - xr) + ky * 4 * yr * (1 - yr)
            inside = (s > 0) & (xb >= -sp) & (xb < W * sp) & (yb >= -sp) \
                & (yb < H * sp)
            dark = torch.remainder(torch.floor(xb / sp) + torch.floor(yb / sp),
                                   2) == 1
            im = torch.where(inside, torch.where(dark, 40.0, 220.0), 130.0)
            im = im.reshape(-1, Hpx, CAL_SS, Wpx, CAL_SS).mean((2, 4))
            out[f0:f0 + CAL_RENDER_BATCH, c] = torch.round(im).to(torch.uint8)
        del v
    return out


def cal_render_large(torch, dev):
    """A CAL_LARGE 8-bit render of a frontal 14 x 14 board of 0.077 m
    squares through a pinhole of focal Wpx / 2, 4 x 4 supersampled, in
    row blocks; and its true corners."""
    Wpx, Hpx = CAL_LARGE
    W = H = 14
    sp = 0.077
    f, z = Wpx / 2, 1.3
    K = np.array([[f, 0, Wpx / 2 - 0.3], [0, f, Hpx / 2 + 0.2], [0, 0, 1]])
    r = np.array([0.1, -0.15, 0.05])
    th = np.linalg.norm(r)
    k = r / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    t = np.array([0, 0, z]) - R @ np.array([(W - 1) * sp / 2,
                                            (H - 1) * sp / 2, 0])
    Hm = K @ np.stack([R[:, 0] * sp, R[:, 1] * sp, t], axis=1)
    Hinv = torch.as_tensor(np.linalg.inv(Hm), device=dev)
    out = torch.empty((Hpx, Wpx), dtype=torch.uint8, device=dev)
    xs = (torch.arange(Wpx * 4, dtype=torch.float64, device=dev) + 0.5) / 4 \
        - 0.5
    rows = 200
    for y0 in range(0, Hpx, rows):
        ys = (torch.arange(y0 * 4, (y0 + rows) * 4, dtype=torch.float64,
                           device=dev) + 0.5) / 4 - 0.5
        ys = ys[:, None]
        w = Hinv[2, 0] * xs + Hinv[2, 1] * ys + Hinv[2, 2]
        bx = (Hinv[0, 0] * xs + Hinv[0, 1] * ys + Hinv[0, 2]) / w
        by = (Hinv[1, 0] * xs + Hinv[1, 1] * ys + Hinv[1, 2]) / w
        inside = (bx >= -1) & (bx < W) & (by >= -1) & (by < H)
        dark = torch.remainder(torch.floor(bx) + torch.floor(by), 2) == 1
        im = torch.where(inside, torch.where(dark, 40.0, 220.0), 130.0)
        out[y0:y0 + rows] = torch.round(
            im.reshape(rows, 4, Wpx, 4).mean((1, 3))).to(torch.uint8)
    ij = np.stack(np.meshgrid(np.arange(W), np.arange(H)), -1).reshape(-1, 2)
    p = (Hm @ np.concatenate([ij, np.ones((len(ij), 1))], 1).T).T
    return out, p[:, :2] / p[:, 2:]


def _detect_all(torch, images, W, H, dev, times=None):
    """find_chessboard_corners of every image (Nframes, 2, Hpx, Wpx):
    name -> (corners, level); through the entry point, or with `times` (a
    detector._StageTimes) through its stages."""
    from mrcal_tpu_torch import find_chessboard_corners
    from mrcal_tpu_torch.detector import _find_chessboard_corners
    out = {}
    for f in range(images.shape[0]):
        for c in range(2):
            im = images[f, c]
            if times is None:
                out[_cal_name(f, c)] = find_chessboard_corners(
                    im, W, H, device=dev)
            else:
                out[_cal_name(f, c)] = _find_chessboard_corners(
                    im.to(torch.float32), W, H, 2, 0.2, times)
    return out


def _launch_log(torch, fn):
    """fn()'s result, its wall, the kernels' launch counts in it, and the
    (B, n, K) shapes of the Schur step's two wrappers' calls."""
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    bc.reset_launches()
    with KernelShapes() as ks:
        out, wall = _sync_time(torch, fn)
    shapes = {k: sorted(set(v)) for k, v in ks.shapes.items()}
    return out, wall, dict(bc.launches), shapes


def phase_calibrate(torch):
    """[calibrate_from_images]: the calibration front end on
    stereo_opencv8_2cam at full size.  168 8-bit images of 800 x 600
    rendered on the card from the true geometry; find_chessboard_corners
    on the card (and on the CPU for CAL_CPU_FRAMES frames: the same
    detections, levels and corners); an in-memory corners.vnl and
    compute_chessboard_corners; seed_stereographic on the card (against
    the CPU's) with the PnP's batched cholesky_factor_solve at (Nobs, 6,
    1), 20 launches per pass; the staged solves of
    tests/test_seeding.py (geometry only, then OPENCV8 in full from zero
    distortions; no outlier rejection), one fused launch and one
    back-substitution per iteration; cameramodels and camera 0's
    valid-intrinsics region.  Gated: detection rate, the corners' rms
    against the truth, the stage-2 rms against the same objective at the
    true geometry, the intrinsics' core and camera 1's translation.
    Returns its summary, and dict(vnl: the corners.vnl text, truth: the
    true geometry) for [tools]."""
    import io
    from mrcal_tpu_torch import (cameramodel, compute_chessboard_corners,
                                 estimate_monocular_calobject_poses_Rt_tocam,
                                 optimize, optimizer_callback, problems,
                                 seed_stereographic)
    from mrcal_tpu_torch import calibration as cal
    from mrcal_tpu_torch.detector import _StageTimes
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    from mrcal_tpu_torch.optimize import spec_from_inputs
    from mrcal_tpu_torch.poseutils import _rt_from_Rt
    phase = "calibrate_from_images"
    dev = torch.device(CAL_DEVICE)
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    walls = {}
    W = H = 14
    truth = problems.stereo_opencv8_2cam_truth(CAL_NFRAMES, device=dev)
    Nf = len(truth["Rt_ref_boardref"])
    Wpx, Hpx = (int(v) for v in truth["imagersize"])
    spacing = truth["spacing"]

    images, walls["render"] = _sync_time(
        torch, lambda: cal_render(torch, truth, W, H, dev))
    log(f"[{phase}] rendered {Nf} x 2 images of {Wpx} x {Hpx} (uint8, "
        f"{CAL_SS} x {CAL_SS} supersamples) on the card in "
        f"{walls['render']:.3f} s; mean {float(images.float().mean()):.2f}")

    # detection: the entry point, timed; then its stages, timed apart
    _detect_all(torch, images[:1], W, H, dev)
    det, walls["detect"] = _sync_time(
        torch, lambda: _detect_all(torch, images, W, H, dev))
    times = _StageTimes()
    _detect_all(torch, images, W, H, dev, times)
    walls["detect_stages"] = dict(times.s)
    found = {k: v for k, v in det.items() if v[0] is not None}
    levels = {}
    for _, lv in found.values():
        levels[lv] = levels.get(lv, 0) + 1
    err = np.concatenate([
        (c - truth["q"][int(k[5:8]), int(k[-5])].reshape(-1, 2)).ravel()
        for k, (c, _) in found.items()])
    corner_rms = float(np.sqrt(np.mean(err ** 2) * 2))
    full_share = len(found) / len(det)
    per_camera = [sum(k.endswith(f"cam{c}.png") for k in found)
                  for c in (0, 1)]
    log(f"[{phase}] detect on the card: {len(found)} of {len(det)} images "
        f"yield the full {W} x {H} grid ({full_share * 100:.1f} %; per "
        f"camera {per_camera}), "
        f"levels {levels}; corners vs the true projections: rms "
        f"{corner_rms:.4f} px, max {np.abs(err).max():.4f} px; "
        f"{walls['detect']:.3f} s ({walls['detect'] / len(det) * 1e3:.2f} "
        "ms per image; stages " + ", ".join(
            f"{k} {v:.3f} s" for k, v in walls["detect_stages"].items())
        + ")")
    missed = sorted(set(det) - set(found))
    log(f"[{phase}] images without the full grid: {missed}")
    if full_share < CAL_FULL_SHARE_MIN or corner_rms > CAL_CORNER_RMS_MAX:
        fail(f"[{phase}] detection: {full_share:.3f} of the images yield "
             f"the grid (at least {CAL_FULL_SHARE_MIN}), corner rms "
             f"{corner_rms} px (at most {CAL_CORNER_RMS_MAX})")

    # the CPU's detections of CAL_CPU_FRAMES frames
    sub = images[:CAL_CPU_FRAMES].cpu()
    det_cpu, walls["detect_cpu"] = _sync_time(
        torch, lambda: _detect_all(torch, sub, W, H, cpu))
    worst = 0.0
    for k, (c, lv) in det_cpu.items():
        c_g, lv_g = det[k]
        if (c is None) != (c_g is None) or lv != lv_g:
            fail(f"[{phase}] {k}: the card's detection (level {lv_g}) is "
                 f"not the CPU's (level {lv})")
        if c is not None:
            worst = max(worst, float(np.abs(c - c_g).max()))
    log(f"[{phase}] detect on the CPU ({len(det_cpu)} images of frames "
        f"0-{CAL_CPU_FRAMES - 1}, {walls['detect_cpu']:.3f} s): the same "
        f"images found at the same levels, corners {worst:.3e} px from "
        f"the card's (tol {CAL_CORNER_PX_TOL:g})")
    if not worst <= CAL_CORNER_PX_TOL:
        fail(f"[{phase}] the card's corners differ from the CPU's by "
             f"{worst} px")

    # corners.vnl in memory, then the observations
    t0 = time.perf_counter()
    text = cal.corners_vnl(
        (k, None if v[0] is None else np.concatenate(
            [v[0], np.full((len(v[0]), 1), float(v[1]))], axis=1))
        for k, v in det.items())
    obs, idx_fc, paths = compute_chessboard_corners(
        W, H, globs_per_camera=("*-cam0.png", "*-cam1.png"),
        corners_cache_vnl=io.StringIO(text))
    walls["vnl"] = time.perf_counter() - t0
    frame_of = np.array([int(p[5:8]) for p in paths])
    B = len(np.unique(idx_fc[:, 0]))
    Nobs = len(obs)
    log(f"[{phase}] corners.vnl: {len(text)} bytes, {Nobs} observations of "
        f"{B} frames, {walls['vnl']:.3f} s")

    # the PnP alone, then the seed: card and CPU
    imagersizes = np.tile(truth["imagersize"], (2, 1))
    stereo_models = [("LENSMODEL_STEREOGRAPHIC",
                      np.array([CAL_FOCAL, CAL_FOCAL, (Wpx - 1) / 2,
                                (Hpx - 1) / 2]))] * 2
    pnp = lambda: estimate_monocular_calobject_poses_Rt_tocam(  # noqa: E731
        idx_fc, obs, spacing, stereo_models, device=dev)
    pnp()
    calls = []
    real = cal.cholesky_factor_solve

    def recording(A, rhs):
        calls.append(tuple(rhs.shape))
        return real(A, rhs)
    cal.cholesky_factor_solve = recording
    try:
        bc.reset_launches()
        _, walls["pnp"] = _sync_time(torch, pnp)
        pnp_launches = bc.launches["cholesky_factor_solve"]
        seed, walls["seed"] = _sync_time(torch, lambda: seed_stereographic(
            imagersizes, CAL_FOCAL, idx_fc, obs, spacing, device=dev))
    finally:
        cal.cholesky_factor_solve = real
    npass = len(calls) // 2 // CAL_PNP_STEPS
    retry = calls[CAL_PNP_STEPS][0] // 2 if npass == 2 else 0
    log(f"[{phase}] PnP on the card: {walls['pnp']:.3f} s, "
        f"{pnp_launches} launches of cholesky_factor_solve at "
        f"{sorted(set(calls))} ({npass} batched passes; {retry} "
        f"observations retried at two focal scales)")
    if not (npass in (1, 2)
            and pnp_launches == npass * CAL_PNP_STEPS * (dev.type == "cuda")
            and calls[:CAL_PNP_STEPS] == [(Nobs, 6, 1)] * CAL_PNP_STEPS
            and len(calls) == 2 * npass * CAL_PNP_STEPS):
        fail(f"[{phase}] the PnP launched {pnp_launches} times at {calls}")
    seed_cpu, walls["seed_cpu"] = _sync_time(
        torch, lambda: seed_stereographic(imagersizes, CAL_FOCAL, idx_fc,
                                          obs, spacing, device="cpu"))
    seed_err = max(float(np.abs(a - b).max()) for a, b in zip(seed, seed_cpu))
    log(f"[{phase}] seed on the card {walls['seed']:.3f} s, on the CPU "
        f"{walls['seed_cpu']:.3f} s; card vs CPU {seed_err:.3e} (tol "
        f"{CAL_SEED_TOL:g}); camera 1 seeded at t "
        f"{np.round(seed[1][0, 3:], 4).tolist()} m")
    if not seed_err <= CAL_SEED_TOL:
        fail(f"[{phase}] the card's seed differs from the CPU's by "
             f"{seed_err}")

    # the staged solves
    n = len(truth["intrinsics"][0])
    oi = dict(
        intrinsics=np.concatenate([seed[0], np.zeros((2, n - 4))], axis=1),
        extrinsics_rt_fromref=seed[1].copy(),
        frames_rt_toref=seed[2].copy(), observations_board=obs,
        indices_frame_camintrinsics_camextrinsics=np.concatenate(
            [idx_fc, idx_fc[:, 1:] - 1], axis=1).astype(np.int32),
        lensmodel=truth["lensmodel"], imagersizes=imagersizes,
        calobject_warp=np.zeros(2), calibration_object_spacing=spacing,
        do_apply_outlier_rejection=False)
    stages = {}
    for stage, extra in (("stage1", CAL_STAGE1), ("stage2", {})):
        oi_s = dict(oi, **extra)
        spec = spec_from_inputs(**oi_s)
        K = spec.Nstate - spec.num_states_frames + 1
        stats, wall, launches, shapes = _launch_log(
            torch, lambda: optimize(precision="f64", device=dev, **SOLVE_KW,
                                    **oi_s))
        niter = stats["niterations"]
        stages[stage] = dict(
            rms=stats["rms_reproj_error__pixels"], niterations=niter,
            wall_s=wall, ms_per_iteration=wall / niter * 1e3,
            launches=launches, shapes={k: [list(x) for x in v]
                                       for k, v in shapes.items()},
            K_counted=K)
        walls[stage] = wall
        log(f"[{phase}] {stage}: rms {stats['rms_reproj_error__pixels']!r} "
            f"px in {niter} iterations, {wall:.3f} s "
            f"({wall / niter * 1e3:.2f} ms/iteration); the kernels ran at "
            f"{shapes} (K = {K} counted from the state: the camera-side "
            f"states and the gradient), launches {launches}")
        check_launches_per_iteration(f"{phase} {stage}", launches, niter)
        fused = shapes["cholesky_factor_solve"]
        if not (len(fused) == 1 and fused[0][:2] == (B, 6)
                and shapes["cholesky_solve_factored"] == [(B, 6, 1)]):
            fail(f"[{phase}] {stage}: the kernels ran at {shapes}, not "
                 f"({B}, 6, K) and ({B}, 6, 1)")
        stages[stage]["K_logged"] = fused[0][2]
        oi.update({k: oi_s[k] for k in ("intrinsics", "extrinsics_rt_fromref",
                                        "frames_rt_toref", "calobject_warp")})

    # the same objective at the true geometry
    oi_true = dict(
        oi, intrinsics=truth["intrinsics"].copy(),
        extrinsics_rt_fromref=truth["extrinsics_rt_fromref"].copy(),
        frames_rt_toref=_rt_from_Rt(torch.as_tensor(
            truth["Rt_ref_boardref"][np.unique(frame_of)])).numpy(),
        calobject_warp=truth["warp"].copy())
    x_true = optimizer_callback(no_jacobian=True, device=dev, **oi_true)[1]
    rms_true = float(np.sqrt(np.mean(x_true ** 2)))
    rms2 = stages["stage2"]["rms"]
    core_err = float(np.abs(oi["intrinsics"][:, :4]
                            - truth["intrinsics"][:, :4]).max())
    t1_err = float(np.linalg.norm(oi["extrinsics_rt_fromref"][0, 3:]
                                  - truth["extrinsics_rt_fromref"][0, 3:]))
    log(f"[{phase}] stage 2 rms {rms2!r} px against {rms_true!r} px at the "
        f"true geometry (the same observations, weights and "
        f"regularization); fx fy cx cy within {core_err:.4f} px of the "
        f"truth (tol {CAL_CORE_PX_TOL:g}), camera 1's t within "
        f"{t1_err * 1e3:.4f} mm (tol {CAL_T1_TOL_M * 1e3:g}); warp "
        f"{oi['calobject_warp'].tolist()} (true {truth['warp'].tolist()})")
    if not (rms2 <= rms_true + CAL_RMS_SLACK and core_err <= CAL_CORE_PX_TOL
            and t1_err <= CAL_T1_TOL_M):
        fail(f"[{phase}] the solve: rms {rms2} (truth {rms_true}), core "
             f"{core_err} px, camera 1's t {t1_err} m")

    # cameramodels and camera 0's valid-intrinsics region
    models = [cameramodel(optimization_inputs=oi, icam_intrinsics=i)
              for i in (0, 1)]
    try:
        import contourpy  # noqa: F401
        branch = "contourpy"
    except ImportError:
        branch = "the bounding box (no contourpy)"
    cal._compute_valid_intrinsics_region(models[0], device=dev)
    region, walls["region"] = _sync_time(
        torch, lambda: cal._compute_valid_intrinsics_region(models[0],
                                                            device=dev))
    if not (len(region) >= 4 and np.isfinite(region).all()
            and np.array_equal(region[0], region[-1])):
        fail(f"[{phase}] the valid-intrinsics region is not a closed "
             f"contour: {region}")
    log(f"[{phase}] valid-intrinsics region of camera 0 by {branch}: "
        f"{len(region)} points, x {region[:, 0].min():.1f}-"
        f"{region[:, 0].max():.1f}, y {region[:, 1].min():.1f}-"
        f"{region[:, 1].max():.1f} px, {walls['region']:.3f} s warm")

    # a 24-MP frame: the detector's wall, no gate
    big, walls["render_large"] = _sync_time(
        torch, lambda: cal_render_large(torch, dev))
    times = _StageTimes()
    from mrcal_tpu_torch.detector import _find_chessboard_corners
    (c_big, lv_big), walls["detect_large"] = _sync_time(
        torch, lambda: _find_chessboard_corners(
            big[0].to(torch.float32), W, H, 2, 0.2, times))
    big_err = (float(np.sqrt(np.mean((c_big - big[1]) ** 2) * 2))
               if c_big is not None else None)
    walls["detect_large_stages"] = dict(times.s)
    log(f"[{phase}] {CAL_LARGE[0]} x {CAL_LARGE[1]} frame: rendered in "
        f"{walls['render_large']:.3f} s; find_chessboard_corners "
        f"{walls['detect_large']:.3f} s (stages " + ", ".join(
            f"{k} {v:.3f} s" for k, v in times.s.items())
        + f"), level {lv_big}, corner rms vs the truth {big_err} px")

    walls["phase"] = time.perf_counter() - t_phase
    log(f"[{phase}] walls (s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in walls.items()
        if not isinstance(v, dict)))
    return dict(images=len(det), found=len(found), levels=levels,
                corner_rms_px=corner_rms, cpu_corner_err_px=worst,
                Nobs=Nobs, frames=B, pnp_launches=pnp_launches,
                pnp_passes=npass, pnp_retried=retry, seed_err=seed_err,
                rms_truth=rms_true, core_err_px=core_err,
                t1_err_m=t1_err, region_points=len(region),
                region_branch=branch, walls=walls, **stages), \
        dict(vnl=text, truth=truth)


# [dense_stereo]: stereo_opencv8_2cam's true pair (two OPENCV8 cameras of
# 800 x 600, 0.22 m apart) rendered at full resolution on the card, looking
# at a textured plane tilted in depth and a textured box in front of it;
# rectified, matched by census+SGM and NCC, and ranged; then a synthetic
# rectified 2-MP pair matched by SGM alone
DS_DEVICE = "cuda"
DS_SS = CAL_SS                          # supersamples per pixel side
DS_RECT = dict(az_fov_deg=50, el_fov_deg=40)
DS_DMAX = 127
DS_NCC_BLOCK = 9
# the plane n.p = n.(0, 0, DS_PLANE_Z) in camera 0's frame, and the box's
# corners (m): 2.4-4.0 m, and 1.45-1.75 m
DS_PLANE_N = np.array([-0.45, 0.15, 1.0])
DS_PLANE_Z = 3.0
DS_BOX = (np.array([-0.45, -0.30, 1.45]), np.array([0.05, 0.10, 1.75]))
DS_TEXEL = 0.004                        # m per texel of the textures
DS_TEX = 1024                           # texture side (texels), wrapped
DS_SEED = 12
DS_FEATURES = 50
DS_FEATURE_MARGIN = 48                  # px from camera 0's edges
DS_ESTIMATE_PX = 3.0                    # q1_estimate: the truth + U(-3, 3)
DS_INTERIOR = 6                         # px off each region's edges
DS_RAW_MARGIN = 4                       # px inside each raw image
DS_LARGE = (1080, 1920)
DS_LARGE_DMAX = 255
DS_LARGE_RAMP = (40.0, 160.0)           # the plane's disparity, x = 0 .. W
DS_LARGE_BOX = (300, 780, 900, 1400, 230)   # y0, y1, x0, x1, disparity
# gates
DS_MAP_ULPS = 2
DS_IMAGE_SHARE = 1e-3                   # pixels that may differ by 1 level
DS_NCC_MARGIN = 1e-5
DS_NCC_SHARE = 1e-3
DS_NCC_PX = 1e-2                        # the same disparity, within this
DS_RANGE_RTOL = 1e-12
DS_MATCH_PX = 1e-9
DS_VALID_MIN = 0.5                      # tests/test_stereo_sgm.py:56-68
DS_MEDIAN_PX = 0.5
DS_WITHIN_PX = 1.5
DS_WITHIN_SHARE = 0.9
DS_RANGE_MEDIAN_REL = 0.02              # tests/test_stereo_sgm.py:131


def ds_textures(torch, dev):
    """The plane's and the box's textures, (DS_TEX, DS_TEX) float64 on dev:
    band-limited noise (tests/test_stereo_sgm.py's recipe, wrapped)
    stretched to a mean of 128 (plane) and 110 (box), sd 40."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(DS_SEED)
    out = []
    for mean in (128.0, 110.0):
        t = gaussian_filter(rng.uniform(0, 255, (DS_TEX, DS_TEX)), 1.0,
                            mode="wrap")
        out.append(torch.as_tensor((t - t.mean()) / t.std() * 40 + mean,
                                   device=dev))
    return out


def ds_sample(torch, tex, u, w):
    """Bilinear samples of the wrapped texture at texel coordinates
    (u, w)."""
    n = tex.shape[0]
    u0, w0 = torch.floor(u), torch.floor(w)
    fu, fw = u - u0, w - w0
    iu = torch.remainder(u0.to(torch.int64), n)
    iw = torch.remainder(w0.to(torch.int64), n)
    iu1, iw1 = torch.remainder(iu + 1, n), torch.remainder(iw + 1, n)
    return ((1 - fw) * ((1 - fu) * tex[iw, iu] + fu * tex[iw, iu1])
            + fw * ((1 - fu) * tex[iw1, iu] + fu * tex[iw1, iu1]))


def ds_hit(torch, o, v):
    """The nearest hit (s > 0) of the rays o + s v ((3,), (N, 3) in camera
    0's frame) with the scene: s, on_box, and each hit's texture
    coordinates (u, w) in texels (the plane's own axes; the box face's
    two other coordinates)."""
    dev, f64 = v.device, torch.float64
    n = torch.as_tensor(DS_PLANE_N / np.linalg.norm(DS_PLANE_N), device=dev)
    s_plane = (n[2] * DS_PLANE_Z - o @ n) / (v @ n)
    lo, hi = (torch.as_tensor(b, device=dev) for b in DS_BOX)
    t1, t2 = (lo - o) / v, (hi - o) / v
    near = torch.minimum(t1, t2)
    t_in, face = near.max(dim=-1)
    t_out = torch.maximum(t1, t2).min(dim=-1).values
    on_box = (t_in <= t_out) & (t_in > 0) & (t_in < s_plane)
    s = torch.where(on_box, t_in, s_plane)
    p = o + s[:, None] * v
    e1 = torch.linalg.cross(torch.tensor([0.0, 1.0, 0.0], dtype=f64,
                                         device=dev), n)
    e1 = e1 / torch.linalg.vector_norm(e1)
    e2 = torch.linalg.cross(n, e1)
    pb = torch.stack([torch.gather(p, 1, ((face + k) % 3)[:, None])[:, 0]
                      for k in (1, 2)], dim=-1)
    uw = torch.where(on_box[:, None], pb, torch.stack([p @ e1, p @ e2], -1))
    return s, on_box, uw / DS_TEXEL


def ds_render(torch, truth, textures, dev):
    """The two cameras' 8-bit images (Hpx, Wpx) of the scene: each of a
    pixel's DS_SS x DS_SS supersamples (cal_rays) meets the scene, the
    texture's value there, averaged and rounded."""
    from mrcal_tpu_torch.poseutils import _invert_rt, _Rt_from_rt
    Wpx, Hpx = (int(v) for v in truth["imagersize"])
    out = []
    for c in range(2):
        rt_cr = (np.zeros(6) if c == 0
                 else truth["extrinsics_rt_fromref"][c - 1])
        Rt_rc = _Rt_from_rt(_invert_rt(torch.as_tensor(rt_cr, device=dev)))
        v = cal_rays(torch, truth, c, dev) @ Rt_rc[:3, :].T
        _, on_box, uw = ds_hit(torch, Rt_rc[3], v)
        del v
        val = torch.where(on_box, ds_sample(torch, textures[1], *uw.T),
                          ds_sample(torch, textures[0], *uw.T))
        val = val.reshape(Hpx, DS_SS, Wpx, DS_SS).mean((1, 3))
        out.append(torch.round(val.clamp(0, 255)).to(torch.uint8))
    return out


def ds_truth(torch, models, rect, dev):
    """The true rectified geometry: each rectified pixel of camera 0
    unprojected, its ray met with the scene, the hit projected into rect1
    and into both raw cameras by the port's own functions.  Returns the
    true disparity and range (Nel, Naz), and the interiors of the plane
    and of the box (seen by both cameras, inside both raw images and
    rect1, DS_INTERIOR px from any edge of the region)."""
    from mrcal_tpu_torch import project, unproject
    from mrcal_tpu_torch.poseutils import _transform_point_Rt
    Naz, Nel = (int(v) for v in rect[0].imagersize())
    yy, xx = torch.meshgrid(
        torch.arange(Nel, dtype=torch.float64, device=dev),
        torch.arange(Naz, dtype=torch.float64, device=dev), indexing="ij")
    q0 = torch.stack([xx, yy], -1).reshape(-1, 2)
    v = unproject(q0, *rect[0].intrinsics(), device=dev)
    Rt_r0 = torch.as_tensor(rect[0].Rt_ref_cam(), device=dev)
    s, on_box, _ = ds_hit(torch, Rt_r0[3], v @ Rt_r0[:3, :].T)
    p = Rt_r0[3] + s[:, None] * (v @ Rt_r0[:3, :].T)
    rng_true = torch.linalg.vector_norm(
        _transform_point_Rt(torch.as_tensor(rect[0].Rt_cam_ref(), device=dev),
                            p), dim=-1)
    q1 = project(_transform_point_Rt(
        torch.as_tensor(rect[1].Rt_cam_ref(), device=dev), p),
        *rect[1].intrinsics(), device=dev)
    disp = q0[:, 0] - q1[:, 0]
    # seen by camera 1: nothing nearer on the ray from its center
    c1 = torch.as_tensor(models[1].Rt_ref_cam()[3], device=dev)
    s1, _, _ = ds_hit(torch, c1, p - c1)
    good = (s1 > 1 - 1e-9) & (q1[:, 0] >= 0)
    for m in models:
        q = project(_transform_point_Rt(
            torch.as_tensor(m.Rt_cam_ref(), device=dev), p),
            *m.intrinsics(), device=dev)
        W, H = (int(x) for x in m.imagersize())
        m = DS_RAW_MARGIN
        good &= ((q[:, 0] >= m) & (q[:, 0] <= W - 1 - m)
                 & (q[:, 1] >= m) & (q[:, 1] <= H - 1 - m))
    regions = {}
    for name, on in (("plane", ~on_box), ("box", on_box)):
        bad = ~(good & on).reshape(1, 1, Nel, Naz)
        k = DS_INTERIOR
        near_bad = torch.nn.functional.max_pool2d(
            bad.to(torch.float32), 2 * k + 1, stride=1, padding=k)[0, 0]
        interior = near_bad == 0
        interior[:k] = interior[-k:] = False
        interior[:, :k] = interior[:, -k:] = False
        regions[name] = interior
    return (disp.reshape(Nel, Naz), rng_true.reshape(Nel, Naz), regions,
            float((q1[:, 1] - q0[:, 1]).abs().max()))


def ds_truth_gate(phase, what, disp, d_true, regions, dmin=0):
    """The JAX test's gates (tests/test_stereo_sgm.py:56-68) on each
    interior region: valid on more than half, median error below 0.5 px,
    more than 90 % within 1.5 px."""
    out = {}
    valid = disp > 0
    for name, region in regions.items():
        sel = region & valid
        share = float(sel.sum()) / max(int(region.sum()), 1)
        err = (disp - d_true).abs()[sel]
        med = float(err.median()) if err.numel() else float("inf")
        within = float((err < DS_WITHIN_PX).float().mean()) \
            if err.numel() else 0.0
        out[name] = dict(pixels=int(region.sum()), valid_share=share,
                         median_err_px=med, within_share=within)
        log(f"[{phase}] {what} vs the truth, {name} interior "
            f"({int(region.sum())} px): valid {share * 100:.2f} %, median "
            f"error {med:.4f} px, {within * 100:.2f} % within "
            f"{DS_WITHIN_PX} px")
        if not (share > DS_VALID_MIN and med < DS_MEDIAN_PX
                and within > DS_WITHIN_SHARE):
            fail(f"[{phase}] {what}, {name}: valid {share}, median {med}, "
                 f"within {within}")
    return out


def ds_images_gate(phase, what, card, cpu):
    """Card and CPU images equal but for at most DS_IMAGE_SHARE of the
    pixels, by one level."""
    diff = np.abs(card.astype(np.int64) - cpu)
    share = float((diff > 0).mean())
    log(f"[{phase}] {what}: card vs CPU differ at {share * 100:.4f} % of "
        f"the pixels, by at most {int(diff.max())}")
    if card.dtype != cpu.dtype or diff.max() > 1 or share > DS_IMAGE_SHARE:
        fail(f"[{phase}] {what}: {share} of the pixels differ, by up to "
             f"{diff.max()} ({card.dtype}, {cpu.dtype})")
    return share


def ds_rel(a, b):
    a, b = (np.asarray(x.cpu() if hasattr(x, "cpu") else x) for x in (a, b))
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def ds_large_pair():
    """A synthetic rectified 1920 x 1080 pair, as tests/test_stereo_sgm.py
    makes its pairs (:33-68): a textured plane whose disparity ramps from
    DS_LARGE_RAMP[0] to [1] across the image (image 1 resampled along
    its rows), and a textured box at a constant disparity in front of
    it, occluding.  Returns the float32 pair, the true disparity and the
    interiors of the plane and of the box."""
    from scipy.ndimage import gaussian_filter
    H, W = DS_LARGE
    d0, d1 = DS_LARGE_RAMP
    y0, y1, x0, x1, d_fg = DS_LARGE_BOX
    rng = np.random.default_rng(DS_SEED + 1)

    def texture():
        return gaussian_filter(rng.uniform(0, 255, (H, W + 320)).astype(
            np.float32), 1.0) * 4
    tex_bg, tex_fg = texture(), texture()
    k = (d1 - d0) / W
    x = np.arange(W, dtype=np.float64)
    im0 = tex_bg[:, 32:32 + W].copy()
    # the point at x in image 0 lands at x - d(x) in image 1
    src = 32 + (x + d0) / (1 - k)
    cols = np.arange(tex_bg.shape[1])
    im1 = np.stack([np.interp(src, cols, row) for row in tex_bg]).astype(
        np.float32)
    im0[y0:y1, x0:x1] = tex_fg[y0:y1, 32 + x0:32 + x1]
    im1[y0:y1, x0 - d_fg:x1 - d_fg] = tex_fg[y0:y1, 32 + x0:32 + x1]
    d_true = np.broadcast_to(d0 + k * x, (H, W)).copy()
    d_true[y0:y1, x0:x1] = d_fg
    fg = np.zeros((H, W), bool)
    fg[y0 + 5:y1 - 5, x0 + 5:x1 - 5] = True
    bg = np.ones((H, W), bool)
    bg[y0 - 6:y1 + 6, x0 - d_fg - 6:x1 + 6] = False
    bg[:, :int(np.ceil(d0 / (1 - k))) + 2] = False
    bg[:6] = bg[-6:] = False
    bg[:, -6:] = False
    return im0, im1, d_true, dict(plane=bg, box=fg)


def ds_sgm_stages(torch, im0, im1, dmax, sync):
    """stereo_matching_sgm(disparity_min=0, disparity_max=dmax) by its
    stages, each timed (sync: the device's synchronize, or None): the
    census codes, the cost volume, the aggregation, the disparity and the
    walls."""
    from mrcal_tpu_torch import stereo_sgm as sgm

    def timed(fn):
        if sync:
            sync()
        t0 = time.perf_counter()
        out = fn()
        if sync:
            sync()
        return out, time.perf_counter() - t0
    walls = {}
    (c0, c1), walls["census"] = timed(lambda: (
        sgm.census_transform(im0), sgm.census_transform(im1)))
    cost, walls["cost_volume"] = timed(
        lambda: sgm.census_cost_volume(c0, c1, 0, dmax))
    agg, walls["passes"] = timed(lambda: sgm._sgm_aggregate(cost, 6.0, 96.0))
    disp, walls["wta_lr"] = timed(lambda: sgm._sgm_disparity(agg, 0, 1))
    return (c0, c1, cost, agg, disp), walls


def phase_dense_stereo(torch):
    """[dense_stereo]: the library half of mrcal-stereo on
    stereo_opencv8_2cam's true models at full resolution, card against
    CPU and against the true geometry; then a 2-MP rectified pair."""
    from mrcal_tpu_torch import (cameramodel, image_transformation_map,
                                 match_feature, pinhole_model_for_reprojection,
                                 problems, rectification_maps,
                                 rectified_system, stereo_matching_ncc,
                                 stereo_matching_sgm, stereo_range,
                                 stereo_unproject, transform_image)
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    from mrcal_tpu_torch.poseutils import _transform_point_Rt
    from mrcal_tpu_torch.stereo import _ncc_scores
    phase = "dense_stereo"
    dev = torch.device(DS_DEVICE)
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()
    bc.reset_launches()
    card, host = {}, {}                 # walls (s), warm on the card

    def on_card(name, fn, reps=2):
        for _ in range(reps - 1):
            fn()
        out, card[name] = _sync_time(torch, fn)
        return out

    def on_cpu(name, fn):
        t0 = time.perf_counter()
        out = fn()
        host[name] = time.perf_counter() - t0
        return out

    truth = problems.stereo_opencv8_2cam_truth(device=dev)
    models = truth["models"]
    textures = ds_textures(torch, dev)
    (raw0, raw1), card["render"] = _sync_time(
        torch, lambda: ds_render(torch, truth, textures, dev))
    raw = [raw0.cpu().numpy(), raw1.cpu().numpy()]
    log(f"[{phase}] rendered the pair on the card ({raw[0].shape[1]} x "
        f"{raw[0].shape[0]}, {DS_SS} x {DS_SS} supersamples) in "
        f"{card['render']:.3f} s; means {raw[0].mean():.2f}, "
        f"{raw[1].mean():.2f}")

    # rectification: the system, the maps and the remap of both images
    rect = on_card("rectified_system", lambda: rectified_system(
        models, **DS_RECT, device=dev))
    rect_cpu = on_cpu("rectified_system", lambda: rectified_system(
        models, **DS_RECT, device=cpu))
    for a, b in zip(rect, rect_cpu):
        if ds_rel(a.intrinsics()[1], b.intrinsics()[1]) > 1e-12 or \
                np.abs(a.extrinsics_rt_fromref()
                       - b.extrinsics_rt_fromref()).max() > 1e-12:
            fail(f"[{phase}] rectified_system: card and CPU differ")
    Naz, Nel = (int(v) for v in rect[0].imagersize())
    maps = on_card("maps", lambda: rectification_maps(models, rect,
                                                      device=dev))
    maps_cpu = on_cpu("maps", lambda: rectification_maps(models, rect,
                                                         device=cpu))
    ulps = np.abs(maps - maps_cpu) / np.spacing(np.abs(maps_cpu))
    log(f"[{phase}] rectified {Naz} x {Nel} (LATLON); maps card vs CPU: "
        f"{float(ulps.max()):.1f} float32 ulps at most")
    if maps.shape != (2, Nel, Naz, 2) or maps.dtype != np.float32 or \
            not ulps.max() <= DS_MAP_ULPS:
        fail(f"[{phase}] maps: {maps.shape} {maps.dtype}, {ulps.max()} ulps")
    rectified = on_card("remap", lambda: [
        transform_image(raw[i], maps[i], device=dev) for i in range(2)])
    rectified_cpu = on_cpu("remap", lambda: [
        transform_image(raw[i], maps_cpu[i], device=cpu) for i in range(2)])
    remap_share = [ds_images_gate(phase, f"rectified image {i}",
                                  rectified[i], rectified_cpu[i])
                   for i in range(2)]

    # census + SGM by stages, on the card (warm) and on the CPU, on the
    # card's rectified pair: bit-equal
    im = [torch.as_tensor(r, device=dev).to(torch.float32) for r in rectified]
    sync = torch.cuda.synchronize
    ds_sgm_stages(torch, *im, DS_DMAX, sync)
    stages, walls = ds_sgm_stages(torch, *im, DS_DMAX, sync)
    card.update(walls)
    stages_cpu, walls = ds_sgm_stages(torch, *(x.cpu() for x in im),
                                      DS_DMAX, None)
    host.update(walls)
    for name, a, b in zip(("census0", "census1", "cost volume", "aggregated",
                           "disparity"), stages, stages_cpu):
        if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
            fail(f"[{phase}] {name}: card and CPU differ")
    disp = on_card("sgm", lambda: stereo_matching_sgm(
        rectified[0], rectified[1], disparity_min=0, disparity_max=DS_DMAX,
        device=dev))
    if disp.dtype != torch.float32 or not torch.equal(disp, stages[-1]):
        fail(f"[{phase}] stereo_matching_sgm is not its stages")
    log(f"[{phase}] census, cost volume ({DS_DMAX + 1} x {Nel} x {Naz}, "
        f"{stages[2].numel() * 4 / 1e6:.1f} MB), aggregation and SGM "
        "disparity: card and CPU bit-equal; valid "
        f"{float((disp > 0).float().mean()) * 100:.2f} %")
    del stages, stages_cpu

    # ranging of the SGM disparity
    r = on_card("range", lambda: stereo_range(disp, rect, device=dev))
    r_cpu = on_cpu("range", lambda: stereo_range(disp.cpu(), rect,
                                                 device=cpu))
    p = on_card("unproject", lambda: stereo_unproject(disp, rect,
                                                      device=dev))
    p_cpu = on_cpu("unproject", lambda: stereo_unproject(disp.cpu(), rect,
                                                         device=cpu))
    range_err = (ds_rel(r, r_cpu), ds_rel(p, p_cpu))
    log(f"[{phase}] stereo_range, stereo_unproject card vs CPU: "
        f"{range_err[0]:.2e}, {range_err[1]:.2e} relative ({r.dtype}, "
        f"{p.dtype})")
    if r.dtype != torch.float64 or p.dtype != torch.float64 or \
            max(range_err) > DS_RANGE_RTOL:
        fail(f"[{phase}] ranging: {range_err}")

    # NCC on the same pair
    ncc = on_card("ncc", lambda: stereo_matching_ncc(
        rectified[0], rectified[1], disparity_max=DS_DMAX,
        block_size=DS_NCC_BLOCK, device=dev))
    ncc_cpu = on_cpu("ncc", lambda: stereo_matching_ncc(
        rectified[0], rectified[1], disparity_max=DS_DMAX,
        block_size=DS_NCC_BLOCK, device=cpu))
    scores = _ncc_scores(*(x.cpu() for x in im), 0, DS_DMAX,
                         DS_NCC_BLOCK)[0]
    top2 = torch.topk(scores, 2, dim=0).values
    clear = (top2[0] - top2[1] > DS_NCC_MARGIN).numpy()
    del scores, top2
    differ = np.abs(ncc - ncc_cpu) > DS_NCC_PX
    log(f"[{phase}] NCC card vs CPU: {int(differ.sum())} pixels differ "
        f"({int(differ[clear].sum())} of them with a clear best score), "
        f"{int((ncc != ncc_cpu).sum())} not bit-equal; valid "
        f"{float((ncc > 0).mean()) * 100:.2f} %")
    if ncc.dtype != np.float32 or differ[clear].any() or \
            differ.mean() > DS_NCC_SHARE:
        fail(f"[{phase}] NCC: card and CPU differ at {differ.sum()} pixels")

    # against the true geometry
    d_true, r_true, regions, epipolar = ds_truth(torch, models, rect, dev)
    log(f"[{phase}] truth: disparities {float(d_true.min()):.1f}-"
        f"{float(d_true.max()):.1f} px, ranges {float(r_true.min()):.3f}-"
        f"{float(r_true.max()):.3f} m; rows of rect0 and rect1 agree to "
        f"{epipolar:.2e} px")
    gates = dict(sgm=ds_truth_gate(phase, "SGM", disp, d_true, regions))
    sel = (disp > 0) & (regions["plane"] | regions["box"])
    range_rel = float(((r - r_true).abs() / r_true)[sel].median())
    log(f"[{phase}] SGM range vs the truth: median relative error "
        f"{range_rel:.5f} over {int(sel.sum())} px")
    if not range_rel < DS_RANGE_MEDIAN_REL:
        fail(f"[{phase}] range: median relative error {range_rel}")
    ncc_t = torch.as_tensor(ncc, device=dev)
    for name, region in regions.items():
        err = (ncc_t - d_true).abs()[region & (ncc_t > 0)]
        log(f"[{phase}] NCC vs the truth (no gate), {name}: valid "
            f"{float((ncc_t > 0)[region].float().mean()) * 100:.2f} %, "
            f"median error {float(err.median()):.4f} px")

    # match_feature: DS_FEATURES features of raw camera 0 in raw camera 1
    rng = np.random.default_rng(DS_SEED + 2)
    Wpx, Hpx = (int(v) for v in truth["imagersize"])
    q0 = np.stack([rng.uniform(DS_FEATURE_MARGIN, Wpx - DS_FEATURE_MARGIN,
                               DS_FEATURES),
                   rng.uniform(DS_FEATURE_MARGIN, Hpx - DS_FEATURE_MARGIN,
                               DS_FEATURES)], -1)
    from mrcal_tpu_torch import unproject, project
    v = unproject(q0, *models[0].intrinsics(), device=dev)
    s, _, _ = ds_hit(torch, torch.zeros(3, dtype=torch.float64, device=dev),
                     v)
    q1_true = project(_transform_point_Rt(
        torch.as_tensor(models[1].Rt_cam_ref(), device=dev),
        s[:, None] * v), *models[1].intrinsics(), device=dev).cpu().numpy()
    est = q1_true + rng.uniform(-DS_ESTIMATE_PX, DS_ESTIMATE_PX,
                                q1_true.shape)

    def matches(d):
        return [match_feature(raw[0], raw[1], q0[i], q1_estimate=est[i],
                              device=d) for i in range(DS_FEATURES)]
    found = on_card("match_feature", lambda: matches(dev))
    found_cpu = on_cpu("match_feature", lambda: matches(cpu))
    worst, err = 0.0, []
    for (a, da), (b, db) in zip(found, found_cpu):
        if (a is None) != (b is None):
            fail(f"[{phase}] match_feature: the card and the CPU disagree on "
                 "a match")
        worst = max(worst, float(np.abs(da["matchoutput_image"]
                                        - db["matchoutput_image"]).max()))
        if a is not None:
            worst = max(worst, float(np.abs(a - b).max()))
    err = [float(np.linalg.norm(a - t)) for (a, _), t in zip(found, q1_true)
           if a is not None]
    log(f"[{phase}] match_feature: {len(err)} of {DS_FEATURES} found; card "
        f"vs CPU {worst:.2e} px (scores too); vs the truth median "
        f"{np.median(err):.4f} px, 90th percentile "
        f"{np.percentile(err, 90):.4f} px")
    if not worst <= DS_MATCH_PX:
        fail(f"[{phase}] match_feature: card and CPU differ by {worst}")

    # mrcal-reproject-image: camera 0 to a pinhole fit to its corners, and
    # again from a copy of it with a valid-intrinsics region
    m_region = cameramodel(models[0])
    m_region.valid_intrinsics_region(np.array(
        [[0, 0], [Wpx - 1, 0], [Wpx - 1, Hpx - 1], [0, Hpx - 1], [0, 0]],
        dtype=float))
    reproj = {}
    for name, m_from, kw in (("reproject", models[0], {}),
                             ("reproject_masked", m_region,
                              dict(mask_valid_intrinsics_region_from=True))):
        def reproject(d):
            pin = pinhole_model_for_reprojection(models[0], fit="corners",
                                                 device=d)
            mapxy = image_transformation_map(m_from, pin, device=d, **kw)
            return mapxy, transform_image(raw[0], mapxy, device=d)
        (mapxy, out) = on_card(name, lambda: reproject(dev))
        (mapxy_cpu, out_cpu) = on_cpu(name, lambda: reproject(cpu))
        ulps = float((np.abs(mapxy - mapxy_cpu)
                      / np.spacing(np.abs(mapxy_cpu))).max())
        masked = float(np.all(mapxy == -1, axis=-1).mean())
        log(f"[{phase}] {name}: map card vs CPU {ulps:.1f} ulps, "
            f"{masked * 100:.2f} % masked")
        if ulps > DS_MAP_ULPS:
            fail(f"[{phase}] {name}: the maps differ by {ulps} ulps")
        reproj[name] = dict(map_ulps=ulps, masked_share=masked,
                            differ_share=ds_images_gate(phase, name, out,
                                                        out_cpu))

    # the 2-MP pair, the card only, against its truth
    im0L, im1L, dL, regionsL = ds_large_pair()
    im0L, im1L = (torch.as_tensor(x, device=dev) for x in (im0L, im1L))
    stereo_matching_sgm(im0L, im1L, disparity_max=DS_LARGE_DMAX, device=dev)
    torch.cuda.reset_peak_memory_stats()
    dispL, card["sgm_2mp"] = _sync_time(torch, lambda: stereo_matching_sgm(
        im0L, im1L, disparity_max=DS_LARGE_DMAX, device=dev))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    volume_gb = (DS_LARGE_DMAX + 1) * dispL.numel() * 4 / 1e9
    log(f"[{phase}] 2-MP pair ({DS_LARGE[1]} x {DS_LARGE[0]}, disparity "
        f"0-{DS_LARGE_DMAX}: a {volume_gb:.2f} GB cost volume): SGM "
        f"{card['sgm_2mp']:.3f} s, peak memory {peak:.3f} GiB")
    gates["sgm_2mp"] = ds_truth_gate(
        phase, "SGM 2-MP", dispL,
        torch.as_tensor(dL, device=dev, dtype=torch.float32),
        {k: torch.as_tensor(v, device=dev) for k, v in regionsL.items()})

    launches = dict(bc.launches)
    if any(launches.values()):
        fail(f"[{phase}] the batched-Cholesky kernels launched: {launches}")
    for k in sorted(card):
        log(f"[{phase}] wall {k}: card {card[k] * 1e3:.3f} ms"
            + (f", CPU {host[k] * 1e3:.3f} ms" if k in host else ""))
    summary = dict(rectified=[Naz, Nel], dmax=DS_DMAX, card_s=card,
                   cpu_s=host, remap_differ_share=remap_share,
                   range_rel_err=range_err, range_median_rel=range_rel,
                   ncc_differ=int(differ.sum()), match_worst_px=worst,
                   match_truth_median_px=float(np.median(err)),
                   reprojection=reproj, truth=gates, peak_2mp_gib=peak,
                   batched_cholesky_launches=launches,
                   wall_phase_s=time.perf_counter() - t_phase)
    log(f"[{phase}] phase {summary['wall_phase_s']:.1f} s")
    pairs = dict(rectified=[x.clone() for x in im], large=(im0L, im1L),
                 raw=raw, models=models)
    return summary, pairs


def phase_dense_stereo_profile(torch, summary, pairs):
    """One SGM call at each size under torch.profiler: device kernels
    launched, the device's busy share of the unprofiled call's wall, and
    the top device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mrcal_tpu_torch import stereo_matching_sgm
    out = {}
    for name, (im0, im1), dmax, wall in (
            ("rectified", pairs["rectified"], DS_DMAX,
             summary["card_s"]["sgm"]),
            ("2mp", pairs["large"], DS_LARGE_DMAX,
             summary["card_s"]["sgm_2mp"])):
        torch.cuda.synchronize()
        # device activity only: the same kernels and device time, and half
        # the host's post-processing of the 26k-66k launches (PERF.md)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            stereo_matching_sgm(im0, im1, disparity_max=dmax)
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        n = sum(e.count for e in kernels)
        log(f"[profile] dense_stereo SGM {name} ({tuple(im0.shape)}, "
            f"disparity 0-{dmax}): {n} device kernels, {busy_ms:.2f} ms "
            f"device busy = {busy_ms / (wall * 1e3) * 100:.1f} % of the "
            f"unprofiled call's {wall * 1e3:.1f} ms")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"[profile]   {e.self_device_time_total / 1e3:8.3f} ms "
                f"{e.count:6d}x  {e.key[:100]}")
        out[name] = dict(kernels=n, device_busy_ms=busy_ms,
                         device_busy_share=busy_ms / (wall * 1e3))
    return out


# [tools]: the port's command-line tools (mrcal_tpu_torch.tools) on
# stereo_opencv8_2cam: mrcal-calibrate-cameras on [calibrate_from_images]'s
# detections, the tools of models on the models it writes, and the array
# functions of mrcal-stereo and mrcal-reproject-image on [dense_stereo]'s
# rendered pair; each on the card, as a user runs it (main(argv) with no
# device), and on the CPU (device="cpu")
TOOLS_DEVICE = None
TOOLS_RMS_TOL = 1e-8                    # px, card vs CPU
TOOLS_GRID = (30, 22)
TOOLS_GRID_PX_TOL = 1e-6                # each model's projection of the grid
TOOLS_RT_TOL = 1e-9                     # camera 1's extrinsics
TOOLS_REPORT_RTOL = 1e-9                # report numbers, relative
TOOLS_PX_TOL = 1e-9                     # reprojected pixels
TOOLS_CONVERT_TO = "LENSMODEL_OPENCV4"
TOOLS_FEATURE = (420.0, 310.0, 3.0)     # camera 0's pixel, its range (m)
TOOLS_POINTS = "# x y\n0 0\n100.5 80.25\n420 310\n799 599\n650.25 120.5\n"


class SolveLog:
    """Records each optimize() call made through mrcal_tpu_torch.optimize
    (the name the tools call): its stats, the kernels' launches in it and
    the (B, n, K) shapes of the Schur step's two wrappers; `total` holds
    every launch of the block, the seed's PnP included."""

    def __enter__(self):
        import mrcal_tpu_torch
        from mrcal_tpu_torch.ops import batched_cholesky as bc
        self.pkg, self.real, self.bc = mrcal_tpu_torch, \
            mrcal_tpu_torch.optimize, bc
        self.calls = []
        bc.reset_launches()

        def optimize(*args, **kw):
            before = dict(bc.launches)
            with KernelShapes() as ks:
                stats = self.real(*args, **kw)
            self.calls.append(dict(
                stats=stats,
                launches={k: bc.launches[k] - before[k] for k in LAUNCHED},
                shapes={k: sorted(set(v)) for k, v in ks.shapes.items()}))
            return stats
        mrcal_tpu_torch.optimize = optimize
        return self

    def __exit__(self, *exc):
        self.pkg.optimize = self.real
        self.total = dict(self.bc.launches)


def run_tool(torch, module, argv, device, stdin=""):
    """module.main(argv, device=device), its standard streams captured:
    (its result, stdout, stderr, wall in s).  SystemExit fails the
    phase."""
    import contextlib
    import io
    out, err = io.StringIO(), io.StringIO()
    saved = sys.stdin
    sys.stdin = io.StringIO(stdin)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            result, wall = _sync_time(torch, lambda: module.main(
                list(argv), device=device))
    except SystemExit as e:
        fail(f"[tools] {module.__name__} {argv} exited {e.code}: "
             f"{out.getvalue()[-2000:]} {err.getvalue()[-2000:]}")
    finally:
        sys.stdin = saved
    return result, out.getvalue(), err.getvalue(), wall


def tools_grid_px(m, m_ref):
    """The largest distance (px) between two models' projections of the
    TOOLS_GRID grid of m_ref's unprojections (unit vectors), on the
    CPU."""
    from mrcal_tpu_torch import project, sample_imager, unproject
    W, H = m_ref.imagersize()
    q = sample_imager(*TOOLS_GRID, W, H, device="cpu")
    v = unproject(q, *m_ref.intrinsics(), normalize=True, device="cpu")
    return float((project(v, *m.intrinsics(), device="cpu")
                  - project(v, *m_ref.intrinsics(), device="cpu"))
                 .abs().max())


def tools_check_solves(phase, solves, what, frames=True):
    """One fused launch and one back-substitution per iteration in every
    solve (none at all in solves without frames); returns the solves'
    (iterations, launches, shapes)."""
    out = []
    for i, c in enumerate(solves.calls):
        niter = c["stats"]["niterations"]
        check_launches_per_iteration(f"{phase} {what} solve {i}",
                                     c["launches"], niter if frames else 0)
        out.append(dict(niterations=niter, launches=c["launches"],
                        shapes={k: [list(x) for x in v]
                                for k, v in c["shapes"].items()}))
    return out


def tools_report_err(a, b):
    """The largest relative difference of two triangulate reports, each
    number group by its own magnitude."""
    assert set(a) == set(b), (sorted(a), sorted(b))
    worst = 0.0
    for k in a:
        x, y = (np.asarray(v, dtype=np.float64) for v in (a[k], b[k]))
        worst = max(worst, float(np.abs(x - y).max()
                                 / max(np.abs(y).max(), 1e-300)))
    return worst


def phase_tools(torch, cal, dense):
    """[tools]: the port's tools at stereo_opencv8_2cam's full width, on
    the card against the same calls on the CPU.  cal:
    phase_calibrate()'s dict(vnl, truth); dense: phase_dense_stereo()'s
    pairs (the raw rendered pair and the true models).  Returns the
    summary, the (B, n, K) shapes of the tools' kernel launches and the
    two cameramodels mrcal-calibrate-cameras wrote on the card."""
    import copy
    from mrcal_tpu_torch import (cameramodel, compose_Rt, profiling, project,
                                 transform_point_Rt, unproject)
    from mrcal_tpu_torch._config import resolve_device
    from mrcal_tpu_torch.tools import (calibrate_cameras, convert_lensmodel,
                                       is_within_valid_intrinsics_region,
                                       reoptimize, reproject_image,
                                       reproject_points, report_fov, stereo,
                                       triangulate)
    phase = "tools"
    t_phase = time.perf_counter()
    dev = resolve_device(TOOLS_DEVICE)
    cpu = torch.device("cpu")
    card, host, launches, summary = {}, {}, {}, {}
    shapes = {"cholesky_factor_solve": set(), "cholesky_solve_factored": set()}
    truth = cal["truth"]
    Wpx, Hpx = (int(v) for v in truth["imagersize"])

    def record_shapes(solves):
        for c in solves.calls:
            for k, v in c["shapes"].items():
                shapes[k].update(v)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_tools.")
    try:
        vnl = os.path.join(tmp, "corners.vnl")
        with open(vnl, "w") as f:
            f.write(cal["vnl"])
        out = {d: os.path.join(tmp, d) for d in ("card", "cpu")}
        for d in out.values():
            os.mkdir(d)

        # mrcal-calibrate-cameras
        def calibrate_argv(outdir):
            return ["--corners-cache", vnl, "--lensmodel",
                    truth["lensmodel"], "--focal", f"{CAL_FOCAL:g}",
                    "--imagersize", str(Wpx), str(Hpx), "--object-spacing",
                    repr(float(truth["spacing"])), "--object-width-n", "14",
                    "--valid-intrinsics-region", "--outdir", outdir,
                    "*-cam0.png", "*-cam1.png"]
        with SolveLog() as solves:
            res, text, _, card["calibrate_cameras"] = run_tool(
                torch, calibrate_cameras, calibrate_argv(out["card"]),
                TOOLS_DEVICE)
        for line in text.splitlines():
            log(f"[{phase}] calibrate_cameras | {line}")
        launches["tools_calibrate_cameras"] = solves.total
        record_shapes(solves)
        pnp = solves.total["cholesky_factor_solve"] - sum(
            c["launches"]["cholesky_factor_solve"] for c in solves.calls)
        if pnp > 0:
            shapes["cholesky_factor_solve"].add(
                (len(res["optimization_inputs"]["observations_board"]), 6,
                 1))
        summary["calibrate_cameras_solves"] = tools_check_solves(
            phase, solves, "calibrate_cameras")
        final = summary["calibrate_cameras_solves"][-1]
        niters = [c["niterations"]
                  for c in summary["calibrate_cameras_solves"]]
        log(f"[{phase}] calibrate_cameras on the card: "
            f"{len(solves.calls)} solves (iterations {niters}), the final "
            f"one {final['niterations']} iterations with "
            f"{final['launches']} launches at {final['shapes']}; "
            f"{pnp} launches in the seed's PnP; every solve one fused "
            "launch and one back-substitution per iteration")
        res_cpu, _, _, host["calibrate_cameras"] = run_tool(
            torch, calibrate_cameras, calibrate_argv(out["cpu"]), "cpu")
        models = [cameramodel(os.path.join(out["card"],
                                           f"camera-{i}.cameramodel"))
                  for i in (0, 1)]
        models_cpu = [cameramodel(os.path.join(out["cpu"],
                                               f"camera-{i}.cameramodel"))
                      for i in (0, 1)]
        grid = max(tools_grid_px(m, mc) for m, mc in zip(models, models_cpu))
        rt_err = float(np.abs(models[1].extrinsics_rt_fromref()
                              - models_cpu[1].extrinsics_rt_fromref()).max())
        rms = [r["stats"]["rms_reproj_error__pixels"] for r in (res, res_cpu)]
        outliers = [int(r["stats"]["Noutliers_board"]) for r in (res, res_cpu)]
        rms_err = abs(rms[0] - rms[1])
        core_err = max(float(np.abs(m.intrinsics()[1][:4]
                                    - truth["intrinsics"][i][:4]).max())
                       for i, m in enumerate(models))
        t1_err = float(np.linalg.norm(
            models[1].extrinsics_rt_fromref()[3:]
            - truth["extrinsics_rt_fromref"][0][3:]))
        regions = [m.valid_intrinsics_region() for m in models]
        summary["calibrate_cameras"] = dict(
            rms=rms[0], rms_cpu=rms[1], rms_err=rms_err,
            Noutliers=outliers[0], Noutliers_cpu=outliers[1],
            grid_px=grid, rt1_err=rt_err, core_err_px=core_err,
            t1_err_m=t1_err,
            region_points=[None if r is None else len(r) for r in regions])
        log(f"[{phase}] calibrate_cameras card vs CPU: rms {rms[0]!r} "
            f"vs {rms[1]!r} px ({rms_err:.2e}, tol {TOOLS_RMS_TOL:g}); "
            f"Noutliers {outliers[0]} vs {outliers[1]}; the models' "
            f"{TOOLS_GRID} grid "
            f"{grid:.2e} px (tol {TOOLS_GRID_PX_TOL:g}); camera 1's "
            f"extrinsics {rt_err:.2e} (tol {TOOLS_RT_TOL:g}); against the "
            f"truth fx fy cx cy within {core_err:.4f} px (tol "
            f"{CAL_CORE_PX_TOL:g}), camera 1's t within {t1_err * 1e3:.4f} "
            f"mm (tol {CAL_T1_TOL_M * 1e3:g}); valid-intrinsics regions of "
            f"{summary['calibrate_cameras']['region_points']} points")
        if not (outliers[0] == outliers[1] and rms_err <= TOOLS_RMS_TOL and grid <= TOOLS_GRID_PX_TOL
                and rt_err <= TOOLS_RT_TOL and core_err <= CAL_CORE_PX_TOL
                and t1_err <= CAL_T1_TOL_M
                and all(r is not None and len(r) >= 4 for r in regions)):
            fail(f"[{phase}] calibrate_cameras: {summary}")
        m0, m1 = (os.path.join(out["card"], f"camera-{i}.cameramodel")
                  for i in (0, 1))

        # mrcal-reoptimize, with profiling.timings() of its solve
        results = {}
        for d, device in (("card", TOOLS_DEVICE), ("cpu", "cpu")):
            profiling.reset()
            with SolveLog() as solves:
                results[d] = run_tool(
                    torch, reoptimize,
                    ["--outfile", os.path.join(out[d], "reoptimized."
                                               "cameramodel"), m0], device)
            if d == "card":
                log(f"[{phase}] profiling.timings() after reoptimize's "
                    f"solve on the card: {json.dumps(profiling.timings())}")
                summary["profiling_timings"] = profiling.timings()
                launches["tools_reoptimize"] = solves.total
                record_shapes(solves)
                summary["reoptimize_solves"] = tools_check_solves(
                    phase, solves, "reoptimize")
        card["reoptimize"], host["reoptimize"] = (results[d][3]
                                                  for d in ("card", "cpu"))
        rms = [results[d][0]["stats"]["rms_reproj_error__pixels"]
               for d in ("card", "cpu")]
        grid = tools_grid_px(results["card"][0]["model"],
                             results["cpu"][0]["model"])
        summary["reoptimize"] = dict(rms=rms, grid_px=grid)
        log(f"[{phase}] reoptimize: rms {rms[0]!r} (CPU {rms[1]!r}), grid "
            f"{grid:.2e} px; {results['card'][2].strip()}")
        if abs(rms[0] - rms[1]) > TOOLS_RMS_TOL or grid > TOOLS_GRID_PX_TOL:
            fail(f"[{phase}] reoptimize: {summary['reoptimize']}")

        # mrcal-convert-lensmodel, by re-solve and by --sampled
        launches["tools_convert_lensmodel"] = dict.fromkeys(LAUNCHED, 0)
        for mode, extra in (("resolve", []), ("sampled", ["--sampled"])):
            results = {}
            for d, device in (("card", TOOLS_DEVICE), ("cpu", "cpu")):
                with SolveLog() as solves:
                    results[d] = run_tool(
                        torch, convert_lensmodel,
                        extra + ["--outfile", os.path.join(
                            out[d], f"{mode}.cameramodel"),
                            TOOLS_CONVERT_TO, m0], device)
                if d == "card":
                    for k in LAUNCHED:
                        launches["tools_convert_lensmodel"][k] += \
                            solves.total[k]
                    record_shapes(solves)
                    # the --sampled fit solves fixed points: no frames, so
                    # no block to factor
                    summary[f"convert_{mode}_solves"] = tools_check_solves(
                        phase, solves, f"convert_lensmodel {mode}",
                        frames=mode == "resolve")
            card[f"convert_{mode}"], host[f"convert_{mode}"] = (
                results[d][3] for d in ("card", "cpu"))
            rms = [results[d][0]["rms"] for d in ("card", "cpu")]
            grid = tools_grid_px(results["card"][0]["model"],
                                 results["cpu"][0]["model"])
            summary[f"convert_{mode}"] = dict(rms=rms, grid_px=grid)
            log(f"[{phase}] convert_lensmodel {mode} to {TOOLS_CONVERT_TO}: "
                f"rms {rms[0]!r} (CPU {rms[1]!r}), grid {grid:.2e} px")
            if abs(rms[0] - rms[1]) > TOOLS_RMS_TOL or \
                    grid > TOOLS_GRID_PX_TOL:
                fail(f"[{phase}] convert_lensmodel {mode}: "
                     f"{summary[f'convert_{mode}']}")

        # mrcal-report-fov, -reproject-points, -is-within-valid-intrinsics-
        # region
        for name, module, argv, stdin, tol in (
                ("report_fov", report_fov, [m0], "", TOOLS_REPORT_RTOL),
                ("reproject_points", reproject_points, [m0, m1],
                 TOOLS_POINTS, TOOLS_PX_TOL),
                ("is_within_valid_intrinsics_region",
                 is_within_valid_intrinsics_region, [m0], TOOLS_POINTS, 0)):
            r, text, _, card[name] = run_tool(torch, module, argv,
                                              TOOLS_DEVICE, stdin)
            r_cpu, _, _, host[name] = run_tool(torch, module, argv, "cpu",
                                               stdin)
            err = float(np.abs(np.asarray(r, np.float64)
                               - np.asarray(r_cpu, np.float64)).max())
            if name == "report_fov":
                err /= max(abs(v) for v in r_cpu)
            summary[name] = dict(err=err, card=np.asarray(r).tolist())
            log(f"[{phase}] {name}: card vs CPU {err:.2e} (tol {tol:g}); "
                + " | ".join(text.strip().splitlines()))
            if not err <= tol:
                fail(f"[{phase}] {name}: card vs CPU {err}")

        # mrcal-triangulate of a pixel pair with both noises
        x0, y0, r0 = TOOLS_FEATURE
        # camera 1's view of the point r0 along camera 0's pixel, 0.3 px off
        v = unproject([x0, y0], *models[0].intrinsics(), normalize=True,
                      device=cpu) * r0
        Rt10 = compose_Rt(models[1].Rt_cam_ref(), models[0].Rt_ref_cam(),
                          device=cpu)
        q1 = project(transform_point_Rt(Rt10, v, device=cpu),
                     *models[1].intrinsics(), device=cpu).numpy() \
            + [0.3, -0.2]
        argv = ["--q-calibration-stdev", "0.3", "--q-observation-stdev",
                "0.3", m0, m1, str(x0), str(y0), repr(float(q1[0])),
                repr(float(q1[1]))]
        r, text, _, card["triangulate"] = run_tool(torch, triangulate, argv,
                                                   TOOLS_DEVICE)
        r_cpu, _, _, host["triangulate"] = run_tool(torch, triangulate, argv,
                                                    "cpu")
        err = tools_report_err(r, r_cpu)
        summary["triangulate"] = dict(report_rel_err=err, range=r["range"])
        for line in text.splitlines():
            log(f"[{phase}] triangulate | {line}")
        log(f"[{phase}] triangulate: the report's numbers card vs CPU "
            f"{err:.2e} relative (tol {TOOLS_REPORT_RTOL:g})")
        if not err <= TOOLS_REPORT_RTOL:
            fail(f"[{phase}] triangulate: card vs CPU {err}")
    finally:
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)

    # mrcal-stereo's and mrcal-reproject-image's array functions on
    # [dense_stereo]'s rendered pair
    raw, dmodels = dense["raw"], dense["models"]
    args = stereo.parse_args(
        ["--az-fov-deg", str(DS_RECT["az_fov_deg"]), "--el-fov-deg",
         str(DS_RECT["el_fov_deg"]), "--disparity-range", "0", str(DS_DMAX),
         "--range-image", "--write-point-cloud", "0.cameramodel",
         "1.cameramodel", "0.png", "1.png"])
    st, card["stereo"] = _sync_time(
        torch, lambda: stereo.stereo(dmodels, raw, args, dev))
    t0 = time.perf_counter()
    st_cpu = stereo.stereo(dmodels, raw, args, cpu)
    host["stereo"] = time.perf_counter() - t0
    differ = [ds_images_gate(phase, f"stereo rectified image {i}",
                             st["rectified"][i], st_cpu["rectified"][i])
              for i in (0, 1)]
    # the matcher and the ranging on the card's rectified pair, on the CPU
    args_r = copy.copy(args)
    args_r.already_rectified = True
    st_r = stereo.stereo(dmodels, st["rectified"], args_r, cpu)
    range_err = ds_rel(st["ranges"], st_r["ranges"])
    if not (np.array_equal(st["disparity"], st_r["disparity"])
            and st["disparity"].dtype == st_r["disparity"].dtype
            and range_err <= DS_RANGE_RTOL):
        fail(f"[{phase}] stereo: the card's SGM disparity is not the CPU's "
             f"on the same rectified pair, or ranges differ by {range_err}")
    d_true, r_true, regions, _ = ds_truth(torch, dmodels, st["rect_models"],
                                          dev)
    disp = torch.as_tensor(st["disparity"], device=dev)
    gates = ds_truth_gate(phase, "stereo SGM", disp, d_true, regions)
    rng_t = torch.as_tensor(st["ranges"], device=dev)
    sel = (disp > 0) & (regions["plane"] | regions["box"])
    range_rel = float(((rng_t - r_true).abs() / r_true)[sel].median())
    summary["stereo"] = dict(rectified_differ_share=differ,
                             range_rel_err=range_err, truth=gates,
                             range_median_rel=range_rel,
                             points=len(st["points"]))
    log(f"[{phase}] stereo (SGM, disparities 0-{DS_DMAX}): rectified "
        f"{tuple(st['disparity'].shape[::-1])}, the card's disparity "
        f"bit-equal to the CPU's on the card's rectified pair, ranges "
        f"{range_err:.2e} relative; range vs the truth median relative "
        f"error {range_rel:.5f}; {len(st['points'])} points in the cloud")
    if not range_rel < DS_RANGE_MEDIAN_REL:
        fail(f"[{phase}] stereo: range median relative error {range_rel}")
    (im, mapxy), card["reproject_image"] = _sync_time(
        torch, lambda: reproject_image.reproject_image(
            raw[0], dmodels[0], None, fit="corners", device=dev))
    t0 = time.perf_counter()
    im_cpu, mapxy_cpu = reproject_image.reproject_image(
        raw[0], dmodels[0], None, fit="corners", device=cpu)
    host["reproject_image"] = time.perf_counter() - t0
    ulps = float((np.abs(mapxy - mapxy_cpu)
                  / np.spacing(np.abs(mapxy_cpu))).max())
    summary["reproject_image"] = dict(
        map_ulps=ulps, differ_share=ds_images_gate(
            phase, "reproject_image", im, im_cpu))
    log(f"[{phase}] reproject_image (camera 0 to its corner-fit pinhole): "
        f"map card vs CPU {ulps:.1f} float32 ulps (tol {DS_MAP_ULPS})")
    if ulps > DS_MAP_ULPS:
        fail(f"[{phase}] reproject_image: the maps differ by {ulps} ulps")

    summary.update(card_s=card, cpu_s=host, launches=launches,
                   wall_phase_s=time.perf_counter() - t_phase)
    log(f"[{phase}] walls (s), card (CPU): " + ", ".join(
        f"{k} {card[k]:.3f} ({host[k]:.3f})" for k in card)
        + f"; the phase {summary['wall_phase_s']:.1f}")
    return summary, {k: sorted(v) for k, v in shapes.items()}, models


VIZ_DEVICE = None
VIZ_DIFF_GRID = 60                      # the tools' default grids
VIZ_UNC_GRID = 30
VIZ_RES_GRID = 40
VIZ_NDISTANCES = 40
VIZ_YAW = 1e-3                          # rad, camera 1 of the second pair
VIZ_PX_TOL = 1e-8                       # difflen, project/unproject, deltau
VIZ_UNC_RTOL = 1e-7                     # uncertainty grids, relative
# of the largest residual or of 1 px, whichever is larger: the residuals
# carry the roundoff of the ~800-px coordinates they are differences of,
# and this calibration's are ~0.03 px (a card-vs-CPU difference of
# 2.9e-13 px was 1.44e-12 of its largest, PERF.md PR 14)
VIZ_RESIDUAL_TOL = 1e-12
VIZ_RES_RTOL = 1e-8                     # resolution, relative
VIZ_POSE_TOL = 1e-12                    # m
VIZ_ROUNDTRIP_PX = 1e-6                 # a converged unprojection


def phase_visualization(torch, models, splined):
    """[visualization]: the data half of every plot of
    mrcal_tpu_torch.visualization and the mrcal-show-* tools at full width
    (the tools' default grids), on the card and then on the CPU in this
    process: for [tools]' two calibrated cameras of stereo_opencv8_2cam
    (`models`) and for splined_30x18's solved model (`splined`).  Each
    array is held card against CPU (VIZ_* tolerances); no batched-Cholesky
    kernel may launch, and nothing draws (no matplotlib is imported).
    Returns the summary: each data function's wall on the card and on the
    CPU, and its difference."""
    from mrcal_tpu_torch import cameramodel, compose_rt
    from mrcal_tpu_torch import visualization as viz
    from mrcal_tpu_torch._config import resolve_device
    from mrcal_tpu_torch.model_analysis import model_resolution__deg_pixel
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    from mrcal_tpu_torch.tools import show_stereo_pair_diff
    phase = "visualization"
    t_phase = time.perf_counter()
    dev = resolve_device(VIZ_DEVICE)
    m0, m1 = models
    m1_yawed = cameramodel(m1)
    m1_yawed.extrinsics_rt_fromref(compose_rt(
        np.array([0.0, VIZ_YAW, 0.0, 0.0, 0.0, 0.0]),
        m1.extrinsics_rt_fromref(), device="cpu").numpy())

    def residuals(icam, device):
        oi = models[icam].optimization_inputs()
        res, obs, _ = viz._board_residuals(oi, icam_intrinsics=icam,
                                           device=device)
        q, r, _ = viz._inlier_residuals(models[icam], None, None, None,
                                        device)
        mean = viz._regional_data(models[icam], None, None, None, 20, None,
                                  device)[0]
        worst = viz._board_observation_data(
            oi, 0, from_worst=True, i_observations_sorted_from_worst=None,
            x=None, residuals=None, device=device)
        return dict(residuals=res, vectorfield=r, histogram=r.ravel(),
                    magnitudes=np.linalg.norm(r, axis=-1),
                    directions_deg=np.degrees(np.arctan2(r[:, 1], r[:, 0])),
                    regional=mean, worst=worst[2],
                    worst_index=np.array(worst[0]), pixels=q)

    def geometry(device):
        d = viz._geometry_data(
            [m0, m1], frames_rt_toref=None, points=None,
            icam_extrinsics_fromsolve=None, cameras_Rt_plot_ref=None,
            show_calobjects="all", show_points="all", calobject_warp=None,
            axis_scale=None, object_width_n=None, object_height_n=None,
            object_spacing=None, device=device)
        return dict(cameras=d["cameras"], boards=d["boards"])

    def splined_correction(device):
        """deltau where the grid's unprojection converged (its projection
        back, (u + deltau) f + c, within VIZ_ROUNDTRIP_PX of the pixel),
        NaN elsewhere: off the observed region the solved spline has no
        inverse, and Newton's result there is roundoff-chaotic."""
        du, q, u, _ = viz._splined_correction_data(
            splined, gridn_width=VIZ_DIFF_GRID, gridn_height=None,
            device=device)
        f, c = (np.asarray(splined.intrinsics()[1][i:i + 2])
                for i in (0, 2))
        converged = np.abs((u + du) * f + c - q).max(axis=-1) \
            <= VIZ_ROUNDTRIP_PX
        return dict(deltau=np.where(converged[..., None], du, np.nan),
                    converged=converged, q=q)

    def uncertainty(isotropic):
        return lambda device: dict(zip(("uncertainty", "q"),
                                       viz._projection_uncertainty_data(
            m0, gridn_width=VIZ_UNC_GRID, gridn_height=None, distance=None,
            isotropic=isotropic, method="mean-pcam",
            observed_pixel_uncertainty=None, device=device)))

    # name -> (the data of the plot on a device, {array: (kind, tolerance)});
    # kind "abs" (an absolute difference), "rel" (relative, each entry),
    # "max" (of the largest entry, or of 1 if that is smaller) or "equal"
    px, unc = ("abs", VIZ_PX_TOL), ("rel", VIZ_UNC_RTOL)
    resid = ("max", VIZ_RESIDUAL_TOL)
    calls = {
        "projection_diff": (lambda device: dict(zip(
            ("difflen", "diff", "q0", "Rt10"), viz._projection_diff_data(
                (m0, m1), gridn_width=VIZ_DIFF_GRID, gridn_height=None,
                distance=None, intrinsics_only=False,
                use_uncertainties=False, focus_center=None,
                focus_radius=-1, implied_Rt10=None, device=device))),
            dict(difflen=px)),
        "projection_uncertainty worstdirection-stdev": (
            uncertainty(False), dict(uncertainty=unc)),
        "projection_uncertainty rms-stdev": (uncertainty(True),
                                             dict(uncertainty=unc)),
        "projection_uncertainty_vs_distance": (lambda device: dict(zip(
            ("distances", "uncertainty"), viz._uncertainty_vs_distance_data(
                m0, where="centroid", distance_min=0.2, distance_max=100.0,
                Ndistances=VIZ_NDISTANCES, method="mean-pcam",
                isotropic=False, observed_pixel_uncertainty=None,
                device=device))), dict(uncertainty=unc)),
        "distortion_off_pinhole": (lambda device: dict(zip(
            ("q", "diff"), viz._distortion_off_pinhole_data(
                m0, gridn_width=VIZ_DIFF_GRID, gridn_height=None,
                device=device))), dict(diff=px)),
        "distortion_off_pinhole_radial": (lambda device: dict(zip(
            ("th_deg", "r_obs", "r_pinhole"),
            viz._radial_data(m0, device=device))),
            dict(th_deg=px, r_pinhole=px)),
        "model_resolution": (lambda device: dict(
            resolution=model_resolution__deg_pixel(
                m0, VIZ_RES_GRID, device=device).cpu().numpy()),
            dict(resolution=("rel", VIZ_RES_RTOL))),
        "residuals camera 0": (lambda device: residuals(0, device),
                               dict(residuals=resid, vectorfield=resid,
                                    magnitudes=resid, regional=resid,
                                    worst=resid,
                                    worst_index=("equal", 0))),
        "residuals camera 1": (lambda device: residuals(1, device),
                               dict(residuals=resid, vectorfield=resid,
                                    magnitudes=resid, regional=resid,
                                    worst=resid,
                                    worst_index=("equal", 0))),
        "geometry": (geometry, dict(cameras=("abs", VIZ_POSE_TOL),
                                    boards=("abs", VIZ_POSE_TOL))),
        "stereo_pair_diff (the tool's rect0 diff)": (
            lambda device: dict(zip(
                ("difflen", "diff", "q0", "Rt10"),
                show_stereo_pair_diff.rect0_diff(
                    [m0, m1], [m0, m1_yawed], 60, 50, device))),
            dict(difflen=px)),
        "stereo_pair_diff": (lambda device: dict(zip(
            ("difflen", "diff", "q0"), viz._stereo_pair_diff_data(
                ((m0, m1), (m0, m1_yawed)), gridn_width=VIZ_DIFF_GRID,
                gridn_height=None, distance=None, device=device))),
            dict(difflen=px)),
        "splined_model_correction": (splined_correction,
                                     dict(deltau=px, converged=("equal", 0),
                                          q=px)),
    }

    def difference(kind, a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            return np.inf
        if kind == "equal":
            return 0.0 if np.array_equal(a, b, equal_nan=True) else np.inf
        ok = ~np.isnan(b)
        if not np.array_equal(ok, ~np.isnan(a)):
            return np.inf
        err = np.abs(a[ok] - b[ok])
        if kind == "rel":
            err = err / np.abs(b[ok])
        elif kind == "max":
            err = err / max(np.abs(b[ok]).max(), 1.0)
        return float(err.max()) if err.size else 0.0

    bc.reset_launches()
    summary = {}
    for name, (fn, gates) in calls.items():
        fn(dev)                 # warm-up: the first call of each shape
        card, wall = _sync_time(torch, lambda: fn(dev))
        t0 = time.perf_counter()
        cpu = fn("cpu")
        wall_cpu = time.perf_counter() - t0
        errs = {k: difference(kind, card[k], cpu[k])
                for k, (kind, _) in gates.items()}
        shapes = {k: list(np.shape(v)) for k, v in card.items()}
        summary[name] = dict(card_s=wall, cpu_s=wall_cpu, err=errs,
                             shapes=shapes)
        extra = ""
        if name == "splined_model_correction":
            n = int(card["converged"].sum())
            summary[name]["converged"] = n
            extra = (f"; the unprojection converged at {n} of "
                     f"{card['converged'].size} pixels on both")
        if name.startswith("residuals"):
            # not gated: the direction of a residual near 0 is roundoff
            d_err = difference("abs", card["directions_deg"],
                               cpu["directions_deg"])
            summary[name]["directions_deg_err"] = d_err
            r = card["histogram"]
            extra = (f"; directions {d_err:.2e} deg, worst observation "
                     f"{int(card['worst_index'])}, {len(r)} histogram "
                     f"samples, rms {float(np.sqrt(np.mean(r * r))):.6f} px")
        log(f"[{phase}] {name} {shapes}: card {wall * 1e3:.1f} ms, CPU "
            f"{wall_cpu * 1e3:.1f} ms; card vs CPU "
            + ", ".join(f"{k} {errs[k]:.2e} ({gates[k][0]}, tol "
                        f"{gates[k][1]:g})" for k in gates) + extra)
        bad = [k for k, (kind, tol) in gates.items()
               if not (errs[k] <= tol and np.isfinite(
                   np.asarray(card[k], np.float64)[~np.isnan(
                       np.asarray(card[k], np.float64))]).all())]
        if bad:
            fail(f"[{phase}] {name}: {bad} disagree, card vs CPU {errs}")
    launches = dict(bc.launches)
    if any(launches.values()):
        fail(f"[{phase}] the plots' data launched batched-Cholesky "
             f"kernels: {launches}")
    if "matplotlib" in sys.modules:
        fail(f"[{phase}] matplotlib was imported")
    wall = time.perf_counter() - t_phase
    log(f"[{phase}] no batched-Cholesky launch ({launches}); nothing "
        f"drawn; the phase {wall:.1f} s")
    return dict(calls=summary, launches=launches, wall_phase_s=wall)


def sfm_points_errors(oi, truth):
    """The solved variable points' and frames' translations' distances from
    the truth (m): median and largest of each."""
    nv = len(oi["points"]) - oi["Npoints_fixed"]
    dp = np.linalg.norm(oi["points"][:nv] - truth["points"][:nv], axis=-1)
    dt = np.linalg.norm(oi["extrinsics_rt_fromref"][:, 3:]
                        - truth["extrinsics_rt_fromref"][:, 3:], axis=-1)
    return dict(points_median_m=float(np.median(dp)),
                points_max_m=float(dp.max()),
                translations_median_m=float(np.median(dt)),
                translations_max_m=float(dt.max()))


def phase_sfm_points(torch):
    """SfM with the points in the state: sfm_points at full size in f64
    (the point blocks' fused solve at SFM_POINTS_SHAPES, no frame block),
    held to the JAX package's rms and iteration count, beside the noise's
    prediction, and its errors against the truth; then
    sfm_points_20k on the card and on the CPU, held to the JAX package's
    rms and to each other, with optimizer_callback card against CPU."""
    from mrcal_tpu_torch import optimize, problems
    from mrcal_tpu_torch.ops import batched_cholesky as bc
    from mrcal_tpu_torch.optimize import spec_from_inputs
    phase = "sfm_points"
    t_phase = time.perf_counter()
    oi, truth = problems.sfm_points(**problems.SFM_POINTS)
    noise = problems.SFM_POINTS["noise_px"]
    Nmeas, Nstate = SFM_POINTS_SHAPE
    rms_pred = float(noise * np.sqrt(1 - Nstate / Nmeas))

    def errors(oi_solved):
        e = sfm_points_errors(oi_solved, truth)
        log(f"[{phase}] against the truth: variable points median "
            f"{e['points_median_m']:.3e} m, largest {e['points_max_m']:.3e}"
            f" m; translations median {e['translations_median_m']:.3e} m, "
            f"largest {e['translations_max_m']:.3e} m")
        return dict(errors=e)

    oi, summary = timed_solve(
        torch, phase, oi, SFM_POINTS_SHAPE, SFM_POINTS_F64_RMS,
        SFM_POINTS_RMS_TOL, niter_range=SFM_POINTS_NITER_RANGE,
        kernel_shapes=SFM_POINTS_SHAPES, solved=errors)
    rms = summary["rms"]
    log(f"[{phase}] rms {rms!r} px, the JAX package's "
        f"{SFM_POINTS_F64_RMS!r} ({rms - SFM_POINTS_F64_RMS:+.3e}, tol "
        f"{SFM_POINTS_RMS_TOL:g}); the noise's prediction {rms_pred!r} "
        f"({(rms / rms_pred - 1) * 100:+.3f} %)")
    summary["rms_predicted"] = rms_pred

    # the reduced size, card against CPU on the same inputs
    p20 = "sfm_points_20k"
    oi20, _ = problems.sfm_points(**problems.SFM_POINTS_20K)
    spec = spec_from_inputs(**oi20)
    if (spec.Nmeasurements, spec.Nstate) != SFM_POINTS_20K_SHAPE:
        fail(f"{p20} has the wrong shape "
             f"{(spec.Nmeasurements, spec.Nstate)}")
    bc.reset_launches()
    with KernelShapes() as ks:
        stats_g, wall_g = _sync_time(torch, lambda: optimize(
            precision="f64", **SOLVE_KW, **_copy(oi20)))
    launches = dict(bc.launches)
    stats_c, wall_c = _sync_time(torch, lambda: optimize(
        device="cpu", precision="f64", **SOLVE_KW, **_copy(oi20)))
    rms_g = stats_g["rms_reproj_error__pixels"]
    rms_c = stats_c["rms_reproj_error__pixels"]
    n_g, n_c = stats_g["niterations"], stats_c["niterations"]
    err_b = float(np.abs(stats_g["b_packed"] - stats_c["b_packed"]).max())
    log(f"[{p20}] f64: rms card {rms_g!r} px in {n_g} iterations "
        f"({wall_g:.3f} s), CPU {rms_c!r} in {n_c} ({wall_c:.3f} s); the "
        f"JAX package's {SFM_POINTS_20K_F64_RMS!r}; card vs CPU b "
        f"{err_b:.3e} (tol {SFM_POINTS_20K_B_ATOL:g}); launches {launches}")
    if not (np.isfinite(stats_g["x"]).all()
            and stats_g["x"].shape == (spec.Nmeasurements,)):
        fail(f"[{p20}] non-finite or misshapen output")
    if not abs(rms_g - SFM_POINTS_20K_F64_RMS) <= SFM_POINTS_20K_RMS_TOL:
        fail(f"[{p20}] rms {rms_g!r} is not within "
             f"{SFM_POINTS_20K_RMS_TOL} of {SFM_POINTS_20K_F64_RMS!r}")
    lo, hi = SFM_POINTS_20K_NITER_RANGE
    if not lo <= n_g <= hi:
        fail(f"[{p20}] the card's solve took {n_g} iterations, not {lo}-{hi}")
    if not err_b <= SFM_POINTS_20K_B_ATOL:
        fail(f"[{p20}] card and CPU b_packed differ by {err_b}")
    check_launches_per_iteration(p20, launches, n_g)
    check_kernel_shapes(p20, ks.shapes, SFM_POINTS_20K_SHAPES)
    callback = phase_callback(torch, p20, oi20)
    summary[p20] = dict(rms=rms_g, rms_cpu=rms_c, niterations=n_g,
                        niterations_cpu=n_c, wall_s=wall_g, wall_cpu_s=wall_c,
                        b_err=err_b, launches=launches, callback=callback)
    summary["wall_phase_s"] = time.perf_counter() - t_phase
    log(f"[{phase}] the phase {summary['wall_phase_s']:.1f} s")
    return oi, summary


def phase_profile(torch, phase, oi, ms_per_iteration):
    """Where the time of the f64 solve goes: its first PROFILE_ITERATIONS
    iterations once more, under torch.profiler; device time by kernel,
    launches per iteration, the device's busy share of the unprofiled
    timed solve's wall over as many iterations (ms_per_iteration each),
    and the device time per launch of each batched-Cholesky kernel.  oi:
    one problem, or a list of them, solved as one batch (iterations are
    then the lockstep iterations)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mrcal_tpu_torch import optimize, optimize_batch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        kw = dict(SOLVE_KW, max_iterations=PROFILE_ITERATIONS)
        if isinstance(oi, list):
            niter = max(s["niterations"] for s in optimize_batch(
                [_copy(u) for u in oi], precision="f64", **kw))
        else:
            niter = optimize(precision="f64", **kw,
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
        f"busy = {busy_ms / (ms_per_iteration * niter) * 100:.1f} % of "
        f"the unprofiled solve's wall over {niter} iterations")
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
                device_busy_share=busy_ms / (ms_per_iteration * niter)), \
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
                        ("splined_30x18", phase_splined),
                        ("cahvor_1cam", phase_cahvor),
                        ("cahvore_1cam", phase_cahvor)):
        others[name] = (phase(torch, name) if phase is phase_cahvor
                        else phase(torch))
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
             others["sfm_triangulated"][1]["wall_s"]),
            ("splined_fleet_8x", phase_batch_splined,
             others["splined_30x18"][1]["wall_s"])):
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
    uncertainty, splined_model = phase_uncertainty(
        torch, oi_main, others["opencv8_4cam"][0],
        others["splined_30x18"][0])
    stamp("uncertainty")
    others["stereo_opencv8_2cam"] = phase_stereo(torch)
    stamp("stereo_opencv8_2cam")
    calib, cal_inputs = phase_calibrate(torch)
    stamp("calibrate_from_images")
    dense, dense_pairs = phase_dense_stereo(torch)
    stamp("dense_stereo")
    tools, tools_shapes, tool_models = phase_tools(torch, cal_inputs,
                                                   dense_pairs)
    del cal_inputs
    stamp("tools")
    visualization = phase_visualization(torch, tool_models, splined_model)
    del tool_models, splined_model
    stamp("visualization")
    others["sfm_points"] = phase_sfm_points(torch)
    stamp("sfm_points")
    # the kernels at the front end's and the tools' shapes, against their
    # plain versions
    calib_shapes = sorted({tuple(sh) for st in ("stage1", "stage2")
                           for v in calib[st]["shapes"].values()
                           for sh in v}
                          | {(calib["Nobs"], 6, 1)}
                          | ({(2 * calib["pnp_retried"], 6, 1)}
                             if calib["pnp_retried"] else set()))
    fused = sorted({sh for sh in calib_shapes if sh[2] > 1
                    or sh[0] != calib["frames"]}
                   | set(tools_shapes["cholesky_factor_solve"]))
    solve = sorted({sh for sh in calib_shapes if sh[0] == calib["frames"]
                    and sh[2] == 1}
                   | set(tools_shapes["cholesky_solve_factored"]))
    check_fused_at(torch, np.random.default_rng(2), sorted(set(fused)
                                                           | set(solve)))
    entries, main_path["launch_floor"] = time_kernels(torch, card, dict(
        cholesky_factor_solve=fused, cholesky_solve_factored=solve))
    stamp("kernel times")
    main_path["profile"], per_launch = phase_profile(
        torch, "main", oi_main, main_path["f64"]["ms_per_iteration"])
    stamp("main profile")
    for name, (oi, summary) in others.items():
        summary["profile"], _ = phase_profile(torch, name, oi,
                                              summary["ms_per_iteration"])
        stamp(f"{name} profile")
    for name, phase in (("fleet_64x_opencv8_1cam", "batch fleet"),
                        ("splined_fleet_8x", "batch splined x8")):
        units, summary = batches[name]
        summary["profile"], _ = phase_profile(
            torch, phase, units, summary["ms_per_lockstep_iteration"])
        stamp(f"{phase} profile")
    dense["profile"] = phase_dense_stereo_profile(torch, dense, dense_pairs)
    del dense_pairs
    stamp("dense_stereo profile")
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
                "odd_frames_launches"][e["name"]],
            calibrate_from_images_stage1=calib["stage1"]["launches"][
                e["name"]],
            calibrate_from_images_stage2=calib["stage2"]["launches"][
                e["name"]],
            calibrate_from_images_pnp=(calib["pnp_launches"]
                                       if e["name"] == "cholesky_factor_solve"
                                       else 0),
            **{path: n[e["name"]] for path, n in tools["launches"].items()},
            visualization=visualization["launches"][e["name"]],
            sfm_points_20k=others["sfm_points"][1]["sfm_points_20k"][
                "launches"][e["name"]])
        e["device_us_per_launch_main_path"] = per_launch[e["name"]]
    log(f"[main] summary {json.dumps(main_path)}")
    for name, (_, summary) in list(others.items()) + list(batches.items()):
        log(f"[{name}] summary {json.dumps(summary)}")
    log(f"[mesh] summary {json.dumps(mesh)}")
    log(f"[callback] summary {json.dumps(callbacks)}")
    log(f"[triangulate] summary {json.dumps(triangulate)}")
    log(f"[uncertainty] summary {json.dumps(uncertainty)}")
    log(f"[calibrate_from_images] summary {json.dumps(calib)}")
    log(f"[dense_stereo] summary {json.dumps(dense)}")
    log(f"[tools] summary {json.dumps(tools)}")
    log(f"[visualization] summary {json.dumps(visualization)}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
