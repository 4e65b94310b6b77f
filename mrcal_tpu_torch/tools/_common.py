"""What the port's tools share: the conversion of results to host arrays
and the parsing of point lists."""

import numpy as np
import torch


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
