"""The JAX package's f64 solves of the sfm_points configurations, on its
CPU backend: the targets that ``chip_smoke.py`` holds the port's solves on
the card to.

    JAX_PLATFORMS=cpu python tests/jax_target_sfm_points.py          # 20k
    JAX_PLATFORMS=cpu python tests/jax_target_sfm_points.py --full   # full

The inputs are the port's builder's (``mrcal_tpu_torch.problems.sfm_points``,
made on the CPU), the geometry perturbed as ``perturbed_oi(seed=1)`` and
0.3 px of noise:

- sfm_points_20k (``SFM_POINTS_20K``, the default): 134 frames of camera 0
  of stereo_opencv8_2cam flying over 5000 ground features, the features in
  the state and the last 4 of them fixed (~2 minutes, most of it XLA's
  compiles).
- sfm_points (``SFM_POINTS``, ``--full``): 398 frames over 15,000 features,
  120,000 measurements and 47,370 states.  On an 8-core Intel Xeon it
  printed rms 0.23389657841660424 px in 64 iterations, the solve 552.6 s
  of wall (the process 561 s), at a peak resident set of 4.95 GB.

Prints the rms, the iteration count, the solve's wall and the process's
peak resident set."""

import argparse
import os
import resource
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import mrcal_tpu  # noqa: E402
from mrcal_tpu_torch import problems  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--full", action="store_true",
                        help="solve sfm_points (SFM_POINTS) instead of "
                             "sfm_points_20k (SFM_POINTS_20K)")
    args = parser.parse_args(argv)
    name, size = (("sfm_points", problems.SFM_POINTS) if args.full
                  else ("sfm_points_20k", problems.SFM_POINTS_20K))
    oi, _ = problems.sfm_points(**size, device="cpu")
    t0 = time.perf_counter()
    stats = mrcal_tpu.optimize(precision="f64", update_threshold=1e-7,
                               max_iterations=2000, **oi)
    wall = time.perf_counter() - t0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    print(f"{name}: rms {stats['rms_reproj_error__pixels']!r} px "
          f"in {stats['niterations']} iterations ({wall:.1f} s, "
          f"Nmeasurements {mrcal_tpu.num_measurements(**oi)}, Nstate "
          f"{mrcal_tpu.num_states(**oi)}, peak RSS {rss:.2f} GB)")


if __name__ == "__main__":
    main()
