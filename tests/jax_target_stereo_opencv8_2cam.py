"""The JAX package's f64 solve of the stereo_opencv8_2cam configuration,
on its CPU backend: the target that ``chip_smoke.py`` holds the port's
solve on the card to.

    JAX_PLATFORMS=cpu python tests/jax_target_stereo_opencv8_2cam.py

The scene is the JAX tests' own recipe (``tests/test_calibration.py``
``make_scene``): two LENSMODEL_OPENCV8 cameras of 800 x 600, camera 1 at
rig spacing 0.22 m, 84 frames of a 14 x 14 board (0.077 m, warp (0.002,
-0.001)) that both cameras see whole.  The optimization_inputs hold the
true geometry; ``make_perfect_observations`` adds 0.3 px of noise, and
``bench._perturbed_oi(seed=1)`` perturbs the geometry, with outlier
rejection off.  Prints the rms, the iteration count and the wall."""

import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import bench  # noqa: E402
import mrcal_tpu  # noqa: E402
from mrcal_tpu.synthetic_data import make_perfect_observations  # noqa: E402
from test_calibration import make_scene  # noqa: E402


def inputs():
    """The configuration's optimization_inputs, before the solve."""
    scene = make_scene(Ncameras=2, Nframes=84, model="LENSMODEL_OPENCV8",
                       W=14, H=14, spacing=0.077, warp=(0.002, -0.001),
                       seed=0, rig_spacing=0.22)
    # the true geometry (as optimization_inputs_from_scene, which would
    # reseed the global RNG before the noise is drawn)
    oi = dict(
        intrinsics=scene["intrinsics_true"].copy(),
        extrinsics_rt_fromref=scene["extrinsics_true"].copy(),
        frames_rt_toref=scene["frames_true"].copy(),
        observations_board=scene["observations"].copy(),
        indices_frame_camintrinsics_camextrinsics=scene["indices"],
        lensmodel=scene["lensmodel"], imagersizes=scene["imagersizes"],
        calobject_warp=scene["warp"].copy(),
        calibration_object_spacing=scene["spacing"])
    make_perfect_observations(oi, observed_pixel_uncertainty=0.3)
    oi = bench._perturbed_oi(oi, seed=1)
    oi["do_apply_outlier_rejection"] = False
    return oi


def main():
    oi = inputs()
    t0 = time.perf_counter()
    stats = mrcal_tpu.optimize(precision="f64", update_threshold=1e-7,
                               max_iterations=2000, **oi)
    wall = time.perf_counter() - t0
    print(f"stereo_opencv8_2cam: rms {stats['rms_reproj_error__pixels']!r} "
          f"px in {stats['niterations']} iterations ({wall:.1f} s, "
          f"Nmeasurements {mrcal_tpu.num_measurements(**oi)}, Nstate "
          f"{mrcal_tpu.num_states(**oi)})")


if __name__ == "__main__":
    main()
