"""Geometry helpers that the model analysis needs, in PyTorch:
Procrustes fits and imager sampling.

Counterpart of the first part of ``mrcal_tpu/utils.py``.  The functions
take numpy arrays or tensors, run on the card unless given
``device="cpu"``, and return tensors.
"""

import numpy as np
import torch

from .poseutils import _as_tensors


def _proper_rotation(M):
    """The rotation nearest M (...,3,3) in the Frobenius sense: U D Vt from
    M's SVD, with D = diag(1, 1, det(U Vt)) so that det(R) = +1."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.cat([torch.ones(det.shape + (2,), dtype=M.dtype,
                              device=M.device), det[..., None]], dim=-1)
    return torch.einsum("...ik,...k,...kj->...ij", U, D, Vt)


def _align_procrustes_points_Rt01(p0, p1, weights):
    w = (weights / torch.sum(weights, dim=-1, keepdim=True))[..., None]
    c0 = torch.sum(p0 * w, dim=-2)
    c1 = torch.sum(p1 * w, dim=-2)
    M = torch.einsum("...ni,...nj,...n->...ij", p0 - c0[..., None, :],
                     p1 - c1[..., None, :], weights)
    R = _proper_rotation(M)
    t = c0 - torch.einsum("...ij,...j->...i", R, c1)
    return torch.cat([R, t[..., None, :]], dim=-2)


def _align_procrustes_vectors_R01(v0, v1, weights):
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    v1 = v1 / torch.linalg.vector_norm(v1, dim=-1, keepdim=True)
    return _proper_rotation(torch.einsum("...ni,...nj,...n->...ij", v0, v1,
                                         weights))


def align_procrustes_points_Rt01(p0, p1, weights=None, *, device=None):
    """Rt01 (...,4,3) minimizing sum w_i |p0_i - (R p1_i + t)|^2 over the
    points (...,N,3): the Kabsch fit, without scale."""
    p0, p1, weights = _as_tensors(device, p0, p1, weights)
    if weights is None:
        weights = torch.ones(p0.shape[:-1], dtype=p0.dtype, device=p0.device)
    return _align_procrustes_points_Rt01(p0, p1, weights)


def align_procrustes_vectors_R01(v0, v1, weights=None, *, device=None):
    """The rotation R01 (...,3,3) that best maps the directions v1 onto v0
    (...,N,3)."""
    v0, v1, weights = _as_tensors(device, v0, v1, weights)
    if weights is None:
        weights = torch.ones(v0.shape[:-1], dtype=v0.dtype, device=v0.device)
    return _align_procrustes_vectors_R01(v0, v1, weights)


def sample_imager(gridn_width, gridn_height, imager_width, imager_height, *,
                  device=None):
    """A regular pixel grid over the imager: (gridn_height, gridn_width,
    2), corner pixels included.  gridn_height None: the imager's aspect
    ratio, rounded."""
    if gridn_height is None:
        gridn_height = int(round(imager_height / imager_width * gridn_width))
    x = np.linspace(0, imager_width - 1, gridn_width)
    y = np.linspace(0, imager_height - 1, gridn_height)
    (q,) = _as_tensors(device, np.stack(np.meshgrid(x, y), axis=-1))
    return q


def sample_imager_unproject(gridn_width, gridn_height, imager_width,
                            imager_height, lensmodel, intrinsics_data,
                            normalize=False, *, device=None):
    """The sample_imager grid q and its unprojection v: returns (v, q)."""
    from .projections import unproject
    q = sample_imager(gridn_width, gridn_height, imager_width, imager_height,
                      device=device)
    return unproject(q, lensmodel, intrinsics_data, normalize=normalize,
                     device=q.device), q
