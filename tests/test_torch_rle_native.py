"""The port's C++ RLE codec (zutis_tpu_torch/native/) against the JAX
package's (zutis_tpu/native/) and the port's numpy codec
(zutis_tpu_torch/ops/rle.py), on numpy-seeded masks and run lengths:

  * strings byte for byte: encode, batch encode, packed encode (with its
    boxes and areas), counts -> strings (runs beyond 2^31 included) and
    strings -> counts;
  * decode round-trips, across the two codecs;
  * rle_iou_batch equals the numpy counts_iou at rtol 0, crowd flags
    included;
  * where the JAX wrapper returns None, the port's raises.

Edge cases: empty and full masks, 1 x N and N x 1 masks, masks whose first
pixel is set, checkerboards (a run per pixel).

The JAX source is compiled here by the port's builder (into the port's
build directory, renamed into place) and the JAX wrapper is pointed at it:
its own in-place build races with other test processes (ROADMAP.md, open
fault 1)."""
import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

import zutis_tpu.native as jnative
from zutis_tpu_torch import native
from zutis_tpu_torch.ops import _build
from zutis_tpu_torch.ops import rle
from zutis_tpu_torch.postproc.instance import (
    col_stride_bits,
    pack_masks_fortran,
)

SHAPES = [(1, 1), (1, 37), (37, 1), (5, 8), (33, 17), (64, 64), (97, 130)]
KINDS = ["empty", "full", "random", "sparse", "box", "first pixel",
         "checkerboard"]


def make_mask(kind: str, h: int, w: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng([seed, h, w, KINDS.index(kind)])
    m = np.zeros((h, w), np.uint8)
    if kind == "full":
        m[:] = 1
    elif kind == "random":
        m = (rng.random((h, w)) < 0.5).astype(np.uint8)
    elif kind == "sparse":
        m = (rng.random((h, w)) < 0.03).astype(np.uint8)
    elif kind == "box":
        m[h // 4:max(h // 4 + 1, 3 * h // 4), w // 4:max(w // 4 + 1, 3 * w // 4)] = 1
    elif kind == "first pixel":
        m[0, 0] = 1
        m[h // 2:, w // 2:] = 1
    elif kind == "checkerboard":
        m = ((np.arange(h)[:, None] + np.arange(w)[None]) % 2).astype(np.uint8)
    return m


@pytest.fixture(scope="module")
def jax_codec():
    """The JAX wrapper over its own source, built by the port's builder."""
    path, _, _ = _build.build(Path(jnative._SRC), "libjaxrle")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB", str(path))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_tried", False)
        assert isinstance(jnative.load_rle_lib(), ctypes.CDLL)
        yield jnative


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_encode_is_byte_identical(jax_codec, kind, shape):
    m = make_mask(kind, *shape)
    got = native.native_encode(m)
    assert got == rle.encode(m)["counts"]
    assert got == jax_codec.native_encode(m)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_round_trips_across_codecs(kind):
    for h, w in SHAPES:
        m = make_mask(kind, h, w)
        s = native.native_encode(m)
        np.testing.assert_array_equal(native.native_decode(s, h, w), m)
        np.testing.assert_array_equal(
            rle.decode({"size": [h, w], "counts": s}), m)
        np.testing.assert_array_equal(
            native.native_decode(rle.encode(m)["counts"], h, w), m)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_batch_encode_is_byte_identical(jax_codec, shape):
    masks = np.stack([make_mask(k, *shape) for k in KINDS])
    got = native.native_encode_batch(masks)
    assert got == [rle.encode(m)["counts"] for m in masks]
    assert got == jax_codec.native_encode_batch(masks)
    assert native.native_encode_batch(masks[:0]) == []


@pytest.mark.parametrize("bucket", [(64, 64), (97, 130), (128, 72)])
def test_packed_encode_is_byte_identical(jax_codec, bucket):
    """Masks packed on the device's layout, each encoded over a native
    window inside its bucket: strings, xyxy boxes and areas."""
    H, W = bucket
    rng = np.random.default_rng(H * W)
    masks = np.stack([make_mask(k, H, W) for k in KINDS])
    packed = pack_masks_fortran(torch.from_numpy(masks.astype(bool))).numpy()
    stride = col_stride_bits(H)
    sel = np.array([6, 0, 2, 3, 2, 1, 5, 4])
    hs = rng.integers(1, H + 1, len(sel))
    ws = rng.integers(1, W + 1, len(sel))
    hs[0], ws[0] = H, W
    got = native.native_encode_packed(packed, sel, stride, hs, ws)
    want = jax_codec.native_encode_packed(packed, sel, stride, hs, ws)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    for i, (j, h, w) in enumerate(zip(sel, hs, ws)):
        window = masks[j, :h, :w]
        assert got[0][i] == rle.encode(window)["counts"]
        assert [float(v) for v in got[1][i]] == rle.to_bbox(window)
        assert got[2][i] == window.sum()


def _run_lengths(rng, n: int, long: bool) -> list:
    runs = rng.integers(0, 40, n).astype(np.int64)
    if long:  # runs beyond 2^31, and deltas that change sign
        runs[::3] = rng.integers(2 ** 31, 2 ** 40, len(runs[::3]))
    return runs.tolist()


@pytest.mark.parametrize("long", [False, True], ids=["short", "beyond 2^31"])
def test_counts_to_strings_and_back_are_byte_identical(jax_codec, long):
    rng = np.random.default_rng(7 + long)
    seqs = [_run_lengths(rng, n, long) for n in (1, 2, 3, 4, 9, 33, 100)]
    seqs.append([0] + seqs[-1][1:])  # a mask whose first pixel is set
    stride = max(len(s) for s in seqs) + 5
    counts = np.full((len(seqs), stride), -7, np.int64)  # junk past the end
    for i, s in enumerate(seqs):
        counts[i, :len(s)] = s
    n_counts = np.array([len(s) for s in seqs])
    got = native.counts_to_strings(counts, n_counts)
    assert got == [rle._compress_counts(s) for s in seqs]
    assert got == jax_codec.counts_to_strings(counts, n_counts)
    for s, string in zip(seqs, got):
        back = native.native_string_to_counts(string)
        assert back.dtype == np.int64 and back.tolist() == s
        assert back.tolist() == rle._decompress_counts(string).tolist()
        assert back.tolist() == jax_codec.native_string_to_counts(string).tolist()
    assert native.counts_to_strings(counts[:0], n_counts[:0]) == []


def _counts(masks):
    return [rle._counts_from_mask(m) for m in masks]


@pytest.mark.parametrize("crowd", ["none", "some", "all"])
def test_rle_iou_equals_numpy_counts_iou(jax_codec, crowd):
    rng = np.random.default_rng(3)
    h, w = 33, 17
    dts = [make_mask(k, h, w, seed=1) for k in KINDS]
    gts = [make_mask(k, h, w, seed=2) for k in ("random", "box", "empty",
                                                 "full", "sparse")]
    flags = {"none": [False] * len(gts), "all": [True] * len(gts),
             "some": list(rng.random(len(gts)) < 0.5)}[crowd]
    got = native.native_rle_iou(_counts(dts), _counts(gts), flags)
    assert got.dtype == np.float64 and got.shape == (len(dts), len(gts))
    np.testing.assert_array_equal(
        got, rle.counts_iou_reference(_counts(dts), _counts(gts), flags))
    np.testing.assert_array_equal(
        got, jax_codec.native_rle_iou(_counts(dts), _counts(gts), flags))
    np.testing.assert_array_equal(
        got, rle.mask_iou(np.stack(dts), np.stack(gts), flags))
    np.testing.assert_array_equal(
        rle.counts_iou(_counts(dts), _counts(gts), flags), got)


def test_rle_iou_of_no_masks_is_empty():
    one = _counts([make_mask("box", 8, 8)])
    assert native.native_rle_iou([], one, [False]).shape == (0, 1)
    assert native.native_rle_iou(one, [], []).shape == (1, 0)


def test_counts_of_parses_with_the_native_codec():
    m = make_mask("random", 33, 17)
    s = rle.encode(m)["counts"]
    assert rle.counts_of({"counts": s}).tolist() == rle._counts_from_mask(m).tolist()
    assert rle.counts_of({"counts": s.encode()}).tolist() == rle._counts_from_mask(m).tolist()
    assert rle.area({"size": [33, 17], "counts": s}) == m.sum()


@pytest.mark.parametrize("call", [
    lambda: native.native_decode("0", 3, 3),  # runs cover 0 of 9 pixels
    lambda: native.native_decode("a", 3, 3),  # a continuation with no end
    lambda: native.native_string_to_counts("a"),
    lambda: native.native_encode(np.zeros((0, 4), np.uint8)),
    lambda: native.native_encode(np.zeros((2, 3, 4), np.uint8)),
    lambda: native.counts_to_strings(np.zeros((1, 4), np.int64), np.array([5])),
    lambda: native.native_rle_iou([np.array([4])], [np.array([4])], []),
    lambda: native.native_encode_packed(np.zeros((1, 8), np.uint8),
                                        np.array([1]), 8, np.array([8]),
                                        np.array([8])),
], ids=["short decode", "truncated decode", "truncated parse", "zero-size",
        "not 2-d", "n_counts past stride", "crowd flags", "sel out of range"])
def test_malformed_input_raises(call):
    with pytest.raises(ValueError):
        call()
