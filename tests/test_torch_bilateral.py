"""The port's bilateral solver (zutis_tpu_torch/ops/bilateral.py) and its
host hole fill and labelling (native/labels.cc) against the JAX package's
host solver (zutis_tpu/ops/bilateral.py: numpy, scipy.sparse CG,
scipy.ndimage), on the CPU:

  * fill and labelling bit-equal to `ndimage.binary_fill_holes` and
    `ndimage.label` on 240 random masks and crafted ones: holes touching
    the border, diagonal-only contacts, components of equal size;
  * the grid's keys, vertices, splat, blur and slice equal to the JAX
    grid's bit for bit, the normalisation to an ulp (torch's CPU sqrt);
  * the soft output within 1e-9 of the JAX solver's on 10 image/mask pairs
    (committed photos at the 683 x 512 of a resized 500 x 375 photo, an
    all-zero mask, a one-pixel image), the binary mask equal; a pixel
    whose JAX soft output lies within 1e-9 of 0.5 is reported;
  * the final choice (`refine_mask`) against the JAX function's own lines
    on masks whose components tie in size.
"""
from pathlib import Path

import numpy as np
import pytest
import torch
from scipy import ndimage

from zutis_tpu.ops import bilateral as jax_bilateral
from zutis_tpu_torch.data.image_io import read_rgb
from zutis_tpu_torch.data.transforms import resize_edge
from zutis_tpu_torch.native import labels
from zutis_tpu_torch.ops import bilateral

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
TOL_SOFT = 1e-9


def _random_masks(seed, n=60):
    rng = np.random.default_rng(seed)
    for i in range(n):
        h, w = (int(v) for v in rng.integers(1, 48, 2))
        p = rng.uniform(0.15, 0.85)
        if i % 3 == 0:  # blocks, so components and holes are larger
            cell = int(rng.integers(2, 6))
            m = np.kron(rng.random((h // cell + 1, w // cell + 1)) < p,
                        np.ones((cell, cell), bool))[:h, :w]
        else:
            m = rng.random((h, w)) < p
        yield m


def _crafted():
    ring = np.zeros((9, 9), bool)
    ring[1:8, 1:8] = True
    ring[3:6, 3:6] = False  # a hole
    open_ring = ring.copy()
    open_ring[4, 1:4] = False  # the hole opened to the border
    diagonal = np.eye(6, dtype=bool) | np.eye(6, dtype=bool)[::-1]
    checker = (np.indices((7, 8)).sum(0) % 2).astype(bool)
    equal = np.zeros((6, 11), bool)
    equal[1:3, 1:3] = equal[1:3, 5:7] = equal[3:5, 8:10] = True
    border_hole = np.ones((5, 6), bool)
    border_hole[0, 2] = border_hole[2, 2] = False
    return [ring, open_ring, diagonal, ~diagonal, checker, equal, border_hole,
            np.zeros((3, 4), bool), np.ones((4, 3), bool),
            np.zeros((1, 1), bool), np.ones((1, 7), bool)]


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fill_and_label_equal_scipy_on_random_masks(seed):
    for m in _random_masks(seed):
        filled = labels.fill_holes(m)
        np.testing.assert_array_equal(filled, ndimage.binary_fill_holes(m))
        for x in (m, filled):
            got, n = labels.label(x)
            want, n_want = ndimage.label(x)
            assert n == n_want and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", range(len(_crafted())))
def test_fill_and_label_equal_scipy_on_crafted_masks(case):
    m = _crafted()[case]
    np.testing.assert_array_equal(labels.fill_holes(m),
                                  ndimage.binary_fill_holes(m))
    got, n = labels.label(m)
    want, n_want = ndimage.label(m)
    assert n == n_want
    np.testing.assert_array_equal(got, want)


def test_label_refuses_a_3d_mask():
    with pytest.raises(ValueError, match="2-D"):
        labels.label(np.zeros((2, 3, 4), bool))


def _photo(i):
    photos = sorted(FIXTURES.glob("photo_*_420_q75.jpg"))
    return resize_edge(read_rgb(photos[i]), 512)


def _blob(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    cy, cx = rng.uniform(0.3, 0.7) * h, rng.uniform(0.3, 0.7) * w
    ry, rx = rng.uniform(0.1, 0.4) * h, rng.uniform(0.1, 0.4) * w
    m = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1
    m[rng.random((h, w)) < 0.02] ^= True  # speckle, as SelfMask leaves
    return m.astype(np.float64)


def _pairs():
    rng = np.random.default_rng(5)
    photo = _photo(0)
    yield "photo 683x512", photo, _blob(*photo.shape[:2], 0)
    yield "photo 683x512, zero mask", photo, np.zeros(photo.shape[:2])
    other = _photo(1)
    yield "photo 683x512 b", other, _blob(*other.shape[:2], 1)
    largest = read_rgb(FIXTURES / "largest_640x480_422_q80_progressive.jpg")
    yield "640x480", largest, _blob(480, 640, 2)
    small = resize_edge(photo, 96)
    yield "photo 128x96", small, _blob(96, 128, 3)
    yield "photo 128x96, full mask", small, np.ones((96, 128))
    noise = rng.integers(0, 256, (40, 56, 3), dtype=np.uint8)
    yield "noise 56x40", noise, _blob(40, 56, 4)
    gray = np.repeat(rng.integers(0, 256, (33, 21, 1), dtype=np.uint8), 3, 2)
    yield "gray 21x33", gray, _blob(33, 21, 5)
    flat = np.full((24, 30, 3), 16, np.uint8)  # luma cell 0, not 1
    yield "flat 30x24", flat, _blob(24, 30, 6)
    yield "one pixel", np.full((1, 1, 3), 200, np.uint8), np.ones((1, 1))


PAIRS = list(_pairs())


@pytest.mark.parametrize("case", range(len(PAIRS)),
                         ids=[name for name, _, _ in PAIRS])
def test_solver_equals_the_jax_host_solver(case):
    _, image, target = PAIRS[case]
    soft_want, mask_want = jax_bilateral.bilateral_solver_output(image, target)
    soft, mask = bilateral.bilateral_solver_output(image, target,
                                                   device="cpu")
    assert soft.dtype == np.float64 and soft.shape == target.shape
    near = int((np.abs(soft_want - 0.5) <= TOL_SOFT).sum())
    if near:
        print(f"{PAIRS[case][0]}: {near} pixels within {TOL_SOFT} of 0.5")
    np.testing.assert_allclose(soft, soft_want, rtol=0, atol=TOL_SOFT)
    np.testing.assert_array_equal(mask, mask_want)


@pytest.mark.parametrize("case", [0, 3, 6, 7])
def test_grid_steps_equal_the_jax_grid(case):
    _, image, target = PAIRS[case]
    want = jax_bilateral.BilateralGrid(image)
    got = bilateral.BilateralGrid(image, device="cpu")
    assert (got.npixels, got.nvertices) == (want.npixels, want.nvertices)
    keys = bilateral.grid_keys(image)
    np.testing.assert_array_equal(np.unique(keys), want._uniq_keys)
    x = np.random.default_rng(case).normal(size=want.nvertices)
    np.testing.assert_array_equal(got.blur(torch.from_numpy(x)).numpy(),
                                  want.blur(x))
    t = target.reshape(-1, 1) * 0.999
    np.testing.assert_array_equal(got.splat(torch.from_numpy(t)).numpy(),
                                  want.splat(t))
    np.testing.assert_array_equal(got.slice(torch.from_numpy(x)).numpy(),
                                  want.slice(x))
    # torch's float64 sqrt on the CPU is not correctly rounded (numpy's
    # and CUDA's are): the normalisation parts from numpy's by an ulp
    n_want, m_want = jax_bilateral._bistochastize(want)
    n, m = bilateral._bistochastize(got)
    np.testing.assert_allclose(n.numpy(), n_want.diagonal(), rtol=4e-16,
                               atol=0)
    np.testing.assert_allclose(m.numpy(), m_want.diagonal(), rtol=1e-15,
                               atol=0)


def _jax_final_choice(soft):
    """The last lines of zutis_tpu/ops/bilateral.py::bilateral_solver_output
    (:181-187)."""
    binary = ndimage.binary_fill_holes(soft > 0.5)
    labeled, n_objects = ndimage.label(binary)
    sizes = [np.sum(labeled == i) for i in range(n_objects + 1)]
    order = np.argsort(sizes)
    try:
        return labeled == order[-2]
    except IndexError:
        return np.ones(soft.shape, bool)


@pytest.mark.parametrize("seed", range(6))
def test_final_choice_breaks_ties_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    soft = np.zeros((40, 60))
    # 2-20 squares of one size, so the largest components tie
    for _ in range(int(rng.integers(2, 21))):
        y, x = rng.integers(0, 36), rng.integers(0, 56)
        soft[y:y + 3, x:x + 3] = 0.9
    if seed % 2:
        soft[:, :] = 1.0 - soft  # the background becomes one component
    np.testing.assert_array_equal(bilateral.refine_mask(soft),
                                  _jax_final_choice(soft))


def test_final_choice_of_an_empty_mask_is_all_ones():
    assert bilateral.refine_mask(np.zeros((5, 7))).all()
