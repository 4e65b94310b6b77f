"""The JAX package's f64 solve of the sfm_points_20k configuration, on its
CPU backend: the target that ``chip_smoke.py`` holds the port's solve on
the card to.

    JAX_PLATFORMS=cpu python tests/jax_target_sfm_points.py

The inputs are the port's builder's (``mrcal_tpu_torch.problems.sfm_points``
at ``SFM_POINTS_20K``, made on the CPU): 134 frames of camera 0 of
stereo_opencv8_2cam flying over 5000 ground features, the features in the
state and the last 4 of them fixed, 0.3 px of noise, the geometry
perturbed as ``perturbed_oi(seed=1)``.  Prints the rms, the iteration
count and the wall (~2 minutes, most of it XLA's compiles)."""

import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import mrcal_tpu  # noqa: E402
from mrcal_tpu_torch import problems  # noqa: E402


def main():
    oi, _ = problems.sfm_points(**problems.SFM_POINTS_20K, device="cpu")
    t0 = time.perf_counter()
    stats = mrcal_tpu.optimize(precision="f64", update_threshold=1e-7,
                               max_iterations=2000, **oi)
    wall = time.perf_counter() - t0
    print(f"sfm_points_20k: rms {stats['rms_reproj_error__pixels']!r} px "
          f"in {stats['niterations']} iterations ({wall:.1f} s, "
          f"Nmeasurements {mrcal_tpu.num_measurements(**oi)}, Nstate "
          f"{mrcal_tpu.num_states(**oi)})")


if __name__ == "__main__":
    main()
