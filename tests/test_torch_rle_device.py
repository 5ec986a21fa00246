"""The port's device RLE (zutis_tpu_torch.ops.rle_device) against
zutis_tpu/ops/rle_device.py: every output bit-equal on crafted masks (empty,
full, one-pixel windows, runs across columns) and on each of the three cap
overflows (more kept masks than k_cap, more transitions in a column than
col_cap, more runs than max_runs); and the counts decode to the masks."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zutis_tpu.ops.rle_device import rle_encode_masks_device as jencode
from zutis_tpu_torch.ops import rle
from zutis_tpu_torch.ops.rle_device import rle_encode_masks_device as encode


def _compare(masks, keep, native_hw=None, **caps):
    got = encode(torch.from_numpy(masks), torch.from_numpy(keep),
                 None if native_hw is None else torch.tensor(native_hw),
                 **caps)
    want = jencode(jnp.asarray(masks), jnp.asarray(keep),
                   None if native_hw is None else jnp.asarray(native_hw),
                   **caps)
    assert set(got) == set(want)
    for key, value in got.items():
        w = np.asarray(want[key])
        assert value.shape == w.shape, key
        np.testing.assert_array_equal(value.numpy(), w, err_msg=key)
        assert value.numpy().dtype == w.dtype, key
    return got


def _random(seed, b, q, h, w, p=0.3):
    rng = np.random.RandomState(seed)
    masks = rng.rand(b, q, h, w) < p
    keep = rng.rand(b, q) < 0.5
    return masks, keep


def _decoded(got, masks, native_hw):
    """Each valid, non-overflowing slot's counts decode to its mask."""
    for bi in range(masks.shape[0]):
        h, w = native_hw[bi]
        for si in range(got["q_index"].shape[1]):
            if not got["valid"][bi, si] or got["overflow"][bi, si]:
                continue
            n = int(got["n_runs"][bi, si]) + 1
            counts = got["counts"][bi, si, :n].tolist()
            m = rle.decode({"size": [h, w], "counts": counts})
            q = int(got["q_index"][bi, si])
            np.testing.assert_array_equal(m, masks[bi, q, :h, :w])
            assert got["area"][bi, si] == m.sum()
            if m.sum():
                assert got["bbox"][bi, si].tolist() == [
                    int(v) for v in rle.to_bbox(m)]


@pytest.mark.parametrize("case", ["empty", "full", "one pixel", "corners",
                                  "column runs"])
def test_crafted_masks_bit_equal(case):
    b, q, h, w = 3, 5, 9, 7
    masks = np.zeros((b, q, h, w), bool)
    keep = np.ones((b, q), bool)
    native_hw = [[9, 7], [4, 3], [1, 1]]
    if case == "full":
        masks[:] = True
    elif case == "one pixel":
        masks[:, :, 0, 0] = True
        masks[0, 1, 8, 6] = True  # the last pixel of the full window
        masks[1, 2, 3, 2] = True  # the last pixel of a 4 x 3 window
    elif case == "corners":
        masks[:, :, 0, :] = True
        masks[:, :, :, 0] = True
        keep[:, 1] = False
    elif case == "column runs":
        masks[:, :, 5:, :] = True  # a run carried from column to column
        masks[:, :, :2, 3] = True
    got = _compare(masks, keep, native_hw)
    _decoded(got, masks, native_hw)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_masks_bit_equal(seed):
    masks, keep = _random(seed, 2, 20, 24, 17, p=0.15)
    native_hw = [[24, 17], [13, 9]]
    got = _compare(masks, keep, native_hw, k_cap=16, col_cap=8, max_runs=256)
    _decoded(got, masks, native_hw)


def test_default_window_is_the_whole_mask():
    masks, keep = _random(3, 2, 6, 8, 8, p=0.1)
    _compare(masks, keep)


def test_more_kept_than_k_cap():
    masks, keep = _random(4, 2, 10, 8, 8, p=0.05)
    keep[0] = True
    got = _compare(masks, keep, k_cap=4, col_cap=8, max_runs=64)
    assert got["n_kept"][0] == 10 and got["valid"][0].all()


def test_column_cap_overflow():
    masks = np.zeros((1, 3, 16, 4), bool)
    masks[0, 0, ::2, 1] = True  # 16 transitions in column 1
    masks[0, 1, :3, :] = True
    keep = np.ones((1, 3), bool)
    got = _compare(masks, keep, col_cap=8, max_runs=512)
    assert got["overflow"][0].tolist() == [True, False, False]


def test_max_runs_overflow():
    masks = np.zeros((1, 2, 8, 8), bool)
    masks[0, 0, ::2, :] = True  # 8 runs of ones, 64 boundaries over columns
    keep = np.ones((1, 2), bool)
    got = _compare(masks, keep, col_cap=8, max_runs=20)
    assert got["overflow"][0].tolist() == [True, False]
    assert got["counts"].shape[-1] == 21


def test_fewer_candidates_than_max_runs():
    """col_cap * W below max_runs: the counts hold col_cap * W + 1 entries,
    and rows fewer than col_cap still fill every extraction."""
    masks, keep = _random(5, 1, 3, 3, 5, p=0.5)
    got = _compare(masks, keep, col_cap=8, max_runs=2048)
    assert got["counts"].shape[-1] == 8 * 5 + 1
