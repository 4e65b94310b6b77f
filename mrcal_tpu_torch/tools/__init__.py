"""The command-line tools of the port, one module per script of the JAX
package's ``tools/`` (``tools/mrcal-calibrate-cameras`` is
``calibrate_cameras``, ``tools/mrcal-show-residuals`` ``show_residuals``):
the same options, report lines, output files and plots.

Run one as ``python -m mrcal_tpu_torch.tools.calibrate_cameras ...``; it
runs on the CUDA card, and raises without one.  Each module's
``main(argv=None, *, device=None)`` is the same tool as a function: it
takes the argument list (``sys.argv[1:]`` by default) and the device
(``device="cpu"`` runs it on the CPU), and returns what it computed.  The
tools that read or write image files keep their computation in a function
of arrays, which ``main`` wraps in the file I/O.

The ``mrcal-show-*`` tools (``show_residuals`` and the rest) and the
options that draw (``calibrate_cameras --explore``, ``convert_lensmodel
--viz``, ``stereo --viz``, ``triangulate --viz``) compute their data on
the device and draw it with matplotlib (``mrcal_tpu_torch.visualization``);
on a machine without matplotlib they compute, print their reports where
they have any, and then raise matplotlib's ``ImportError``.
"""
