"""The port's census + SGM matcher against the JAX package's, on the CPU,
bit for bit: the census codes, the Hamming cost volume, the 4-path
aggregation and the disparity, on grey and colour pairs, with
disparity_min > 0, two left-right thresholds and a pair with large flat
patches, where the aggregated costs tie and argmin must take the first
minimum.  Every value is an integer-valued float32, so there is no
tolerance."""

import numpy as np
import pytest
import torch

import mrcal_tpu_torch
import mrcal_tpu_torch.stereo_sgm as ts

from jax_references import (SGM_CASES, SGM_SHAPE, jax_reference_pool,
                            sgm_pair, sgm_references)
from test_torch_residuals import torch_threads  # noqa: F401

# the JAX references in two processes: one compile of the JAX package's
# jitted disparity per (disparity range, threshold)
CHILDREN = [["plane", "box", "colour", "flat"], ["dmin", "lr3"]]


@pytest.fixture(scope="module")
def jax_refs():
    with jax_reference_pool(len(CHILDREN), compiled=False) as pool:
        futures = [pool.submit(sgm_references, names) for names in CHILDREN]
        refs = {}
        for f in futures:
            refs.update(f.result(timeout=600))
        yield refs


GREY = [n for n, (kind, _, _, thr) in SGM_CASES.items()
        if kind != "colour" and thr == 1]


@pytest.mark.parametrize("name", GREY)
def test_census_and_cost_volume_bit_equal(jax_refs, name):
    kind, dmin, dmax, _ = SGM_CASES[name]
    want = jax_refs[name]
    census = [ts.census_transform(im, device="cpu") for im in sgm_pair(kind)]
    for c, w in zip(census, (want["census0"], want["census1"])):
        assert c.dtype == torch.int32 and c.shape == SGM_SHAPE
        assert np.array_equal(c.numpy(), w)
    cost = ts.census_cost_volume(*census, dmin, dmax)
    assert cost.dtype == torch.float32
    assert cost.shape == (dmax - dmin + 1,) + SGM_SHAPE
    assert np.array_equal(cost.numpy(), want["cost"])


@pytest.mark.parametrize("name", GREY)
def test_aggregation_bit_equal(jax_refs, name):
    want = jax_refs[name]
    agg = ts._sgm_aggregate(torch.as_tensor(want["cost"]), 6.0, 96.0)
    assert agg.dtype == torch.float32
    assert np.array_equal(agg.numpy(), want["agg"])


@pytest.mark.parametrize("name", list(SGM_CASES))
def test_disparity_bit_equal(jax_refs, name):
    kind, dmin, dmax, thr = SGM_CASES[name]
    im0, im1 = sgm_pair(kind)
    got = mrcal_tpu_torch.stereo_matching_sgm(
        im0, im1, disparity_min=dmin, disparity_max=dmax,
        lr_consistency_threshold=thr, device="cpu")
    want = jax_refs[name]["disparity"]
    assert got.dtype == torch.float32 and want.dtype == np.float32
    assert got.device.type == "cpu" and got.shape == SGM_SHAPE
    assert np.array_equal(got.numpy(), want)
    # the pair is matched, not only reproduced
    assert (want > 0).mean() > 0.5


def test_flat_patches_tie(jax_refs):
    """The flat pair's costs tie at a third of the pixels, and its
    aggregated costs at dozens: the first minimum is the one taken."""
    def ties(v):
        return (v == v.amin(0, keepdim=True)).sum(0) > 1
    want = jax_refs["flat"]
    assert ties(torch.as_tensor(want["cost"])).float().mean() > 0.2
    agg = torch.as_tensor(want["agg"])
    assert ties(agg).sum() > 20
    first = torch.where(agg == agg.amin(0, keepdim=True),
                        torch.arange(len(agg))[:, None, None],
                        len(agg)).amin(0)
    assert torch.equal(torch.argmin(agg, dim=0), first)


def test_popcount_every_bit():
    v = torch.tensor([0, 1, 0xFFFFFF, 0x7FFFFFFF, -1, -2 ** 31, 0x55AA55],
                     dtype=torch.int32)
    want = [bin(int(x) & 0xFFFFFFFF).count("1") for x in v]
    assert ts._popcount(v).tolist() == want
