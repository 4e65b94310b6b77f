"""What the port's tools share: the refusal of the drawing options and
the conversion of results to host arrays."""

import numpy as np
import torch

# where the port of the drawing code stands in the repository's plan
_NEXT_SLICE = ("ROADMAP.md queue 1 item 4: visualization.py, the "
               "mrcal-show-* tools and the drawing options")


def refuse_drawing(option):
    """Exit nonzero: `option` draws through visualization.py, which the
    port does not have yet."""
    raise SystemExit(f"{option} draws through visualization.py, which "
                     f"mrcal_tpu_torch does not have yet ({_NEXT_SLICE})")


def host(x):
    """A result of the port (a tensor anywhere, or an array) as numpy."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def read_points(f):
    """The 'x y' rows of a text stream (comment and blank lines skipped),
    (N, 2) float64."""
    return np.array([[float(x) for x in line.split()[:2]]
                     for line in f if line.strip()
                     and not line.startswith("#")])
