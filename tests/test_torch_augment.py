"""The port's resampler and augmentations (data/transforms.py,
data/augment.py, data/advanced_copy_paste.py) against Pillow, OpenCV and
the JAX package's functions (zutis_tpu/data/...): from the same generator
state, every uint8 result is bit-equal and the generators end in the same
state. The Gaussian blur is bit-equal to cv2.GaussianBlur (0 differing
pixels over every case here)."""
import cv2
import numpy as np
import pytest
from PIL import Image, ImageEnhance

from zutis_tpu.data import advanced_copy_paste as jax_acp
from zutis_tpu.data import augment as jax_aug
from zutis_tpu.data import transforms as jax_tf
from zutis_tpu_torch.data import advanced_copy_paste as acp
from zutis_tpu_torch.data import augment as aug
from zutis_tpu_torch.data import transforms as tf
from zutis_tpu_torch.native import image as native_image

PIL_FILTERS = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC,
               "lanczos": Image.LANCZOS, "nearest": Image.NEAREST}


def picture(h, w, seed):
    rng = np.random.default_rng(seed)
    small = rng.integers(0, 256, (h // 6 + 2, w // 6 + 2, 3), dtype=np.uint8)
    big = np.asarray(Image.fromarray(small).resize((w, h), Image.BICUBIC))
    noisy = big.astype(np.int16) + rng.integers(-15, 16, big.shape)
    return np.clip(noisy, 0, 255).astype(np.uint8)


def rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def same_state(a, b):
    assert a.bit_generator.state == b.bit_generator.state


SIZES = [(1, 1), (7, 5), (33, 17), (96, 128)]
TARGETS = [(1, 1), (3, 9), (40, 40), (200, 75)]


# mode I (the int32 masks) is resampled with NEAREST only
MODES_FILTERS = [(m, f) for m in ("L", "RGB", "F") for f in sorted(PIL_FILTERS)
                 ] + [("I", "nearest")]


@pytest.mark.parametrize("mode,resample", MODES_FILTERS)
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_equals_pillow(size, mode, resample):
    rng = np.random.default_rng(size[0] * 31 + size[1])
    h, w = size
    if mode == "RGB":
        arr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    elif mode == "L":
        arr = rng.integers(0, 256, (h, w), dtype=np.uint8)
    elif mode == "F":
        arr = rng.normal(size=(h, w)).astype(np.float32)
    else:
        arr = rng.integers(0, 20, (h, w)).astype(np.int32)
    im = Image.fromarray(arr, mode="I") if mode == "I" else Image.fromarray(arr)
    for th, tw in TARGETS + [(h * 3, w), (h, w * 2 + 1)]:
        want = np.asarray(im.resize((tw, th), PIL_FILTERS[resample]))
        got = tf.resize(arr, (tw, th), resample)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("edge", ["shorter", "longer", "both"])
@pytest.mark.parametrize("interp", ["bilinear", "nearest", "bicubic"])
def test_resize_edge_and_normalize_equal_jax(edge, interp):
    img = picture(75, 100, seed=1)
    size = (50, 70) if edge == "both" else 60
    want = np.asarray(jax_tf.resize_edge(Image.fromarray(img), size, edge,
                                         interp))
    got = tf.resize_edge(img, size, edge, interp)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tf.normalize_image(got),
                                  jax_tf.normalize_image(Image.fromarray(got)))
    arr = tf.normalize_image(got)
    for multiple in (1, 16, 32):
        (pa, ha), (pj, hj) = (tf.pad_to_multiple(arr, multiple, -1.0),
                              jax_tf.pad_to_multiple(arr, multiple, -1.0))
        np.testing.assert_array_equal(pa, pj)
        assert ha == hj


def test_resize_refuses_what_pillow_would_not_do_here():
    with pytest.raises(ValueError):
        tf.resize(np.zeros((4, 4), np.int32), (2, 2), "bilinear")
    with pytest.raises(ValueError):
        tf.resize(np.zeros((4, 4), np.uint8), (0, 2), "bilinear")


@pytest.mark.parametrize("seed", range(8))
def test_geometric_augmentations_equal_jax(seed):
    r = np.random.default_rng(seed)
    h, w = (int(v) for v in r.integers(20, 140, 2))
    img = picture(h, w, seed)
    mask = (r.random((h, w)) > 0.4).astype(np.int32)
    r1, r2 = rngs(seed + 100)
    for scale_range in ((0.1, 1.0), (1.0, 1.0), (0.5, 2.0)):
        ij, mj = jax_aug.random_scale(r1, Image.fromarray(img), scale_range,
                                      mask)
        ip, mp = aug.random_scale(r2, img, scale_range, mask)
        np.testing.assert_array_equal(ip, np.asarray(ij))
        np.testing.assert_array_equal(mp, mj)
        assert mp.dtype == mj.dtype
        for crop in (16, 64, 200):
            cj, cmj = jax_aug.random_crop(r1, ij, crop, mj, ignore_index=255)
            cp, cmp_ = aug.random_crop(r2, ip, crop, mp, ignore_index=255)
            np.testing.assert_array_equal(cp, np.asarray(cj))
            np.testing.assert_array_equal(cmp_, cmj)
            fj, fmj = jax_aug.random_hflip(r1, cj, 0.5, cmj)
            fp, fmp = aug.random_hflip(r2, cp, 0.5, cmp_)
            np.testing.assert_array_equal(fp, np.asarray(fj))
            np.testing.assert_array_equal(fmp, fmj)
    same_state(r1, r2)


@pytest.mark.parametrize("factor", [0.0, 0.2, 0.5, 1.0, 1.37, 1.8, 2.5])
def test_enhance_ops_equal_pillow(factor):
    img = picture(37, 53, seed=int(factor * 10))
    im = Image.fromarray(img)
    for ours, theirs in ((aug.adjust_brightness, ImageEnhance.Brightness),
                         (aug.adjust_contrast, ImageEnhance.Contrast),
                         (aug.adjust_saturation, ImageEnhance.Color)):
        np.testing.assert_array_equal(
            ours(img, factor), np.asarray(theirs(im).enhance(factor)))
    np.testing.assert_array_equal(aug.to_luma(img), np.asarray(im.convert("L")))


@pytest.mark.parametrize("shift", [1, 37, -51, 128, 255])
def test_hue_shift_equals_pillow_on_every_colour(shift):
    axis = np.arange(256, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                   -1).reshape(4096, 4096, 3)
    if shift not in (37, -51):  # two shifts over all 2^24 colours
        rgb = rgb[::7, ::5]
    hsv = np.array(Image.fromarray(rgb).convert("HSV"))
    hsv[..., 0] = (hsv[..., 0].astype(np.int32) + shift) % 256
    want = np.asarray(Image.fromarray(hsv, "HSV").convert("RGB"))
    np.testing.assert_array_equal(native_image.hue_shift(rgb, shift), want)


@pytest.mark.parametrize("seed", range(12))
def test_photometric_augmentations_equal_jax(seed):
    img = picture(48 + 4 * seed, 64, seed)
    r1, r2 = rngs(seed)
    for _ in range(3):
        np.testing.assert_array_equal(
            aug.color_jitter(r2, img),
            np.asarray(jax_aug.color_jitter(r1, Image.fromarray(img))))
        np.testing.assert_array_equal(
            aug.photometric_augmentations(r2, img),
            np.asarray(jax_aug.photometric_augmentations(
                r1, Image.fromarray(img))))
        np.testing.assert_array_equal(
            aug.gaussian_blur(r2, img, p=1.0),
            np.asarray(jax_aug.gaussian_blur(r1, Image.fromarray(img), p=1.0)))
    same_state(r1, r2)


@pytest.mark.parametrize("ksize", [1, 3, 5, 9, 39])
@pytest.mark.parametrize("channels", [1, 3])
def test_gaussian_blur_equals_cv2(ksize, channels):
    rng = np.random.default_rng(ksize * 3 + channels)
    differing = 0
    for sigma in np.concatenate([rng.uniform(0.1, 2.0, 24), [0.1, 2.0, 1.0]]):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        img = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
        if channels == 1:
            img = img[..., 0]
        want = cv2.GaussianBlur(img, (ksize, ksize), float(sigma))
        got = native_image.gaussian_blur(img, ksize, float(sigma))
        differing += int((got != want).sum())
    assert differing == 0


def test_gaussian_blur_at_the_training_crop_equals_cv2():
    img = picture(384, 384, seed=3)
    for sigma in np.linspace(0.1, 2.0, 20):
        np.testing.assert_array_equal(
            native_image.gaussian_blur(img, 39, float(sigma)),
            cv2.GaussianBlur(img, (39, 39), float(sigma)))


@pytest.mark.parametrize("seed", range(6))
def test_copy_paste_equals_jax(seed):
    rng = np.random.default_rng(seed)
    n, S = 4, 48
    images = [rng.normal(size=(3, S, S)).astype(np.float32) for _ in range(n)]
    sems, insts = [], []
    for i in range(n):
        m = np.zeros((S, S), np.int32)
        y, x = rng.integers(0, S - 10, 2)
        m[y:y + rng.integers(2, 10), x:x + rng.integers(2, 10)] = 1
        if i == 2:
            m[:] = 0  # an empty object is skipped
        sem = m * (i + 1)
        sem[:2] = 255
        sems.append(sem)
        insts.append(m * (i + 1))
    r1, r2 = rngs(seed)
    want = jax_aug.copy_paste(r1, images, sems, insts)
    got = aug.copy_paste(r2, images, sems, insts)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    same_state(r1, r2)
    assert aug.mask_to_bbox(sems[0] == 1) == jax_aug.mask_to_bbox(sems[0] == 1)
    assert aug.mask_to_bbox(np.zeros((3, 3))) == (-1, -1, -1, -1)


@pytest.mark.parametrize("edge", ["shorter", "longer", "both"])
@pytest.mark.parametrize("size", [(40, 64), (64, 40), (1, 9), (50, 50)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_resize_image_mask_equals_jax(size, edge):
    rng = np.random.default_rng(size[0] + size[1])
    image = rng.normal(size=(3, *size)).astype(np.float32)
    mask = (rng.random(size) > 0.5).astype(np.int64)
    for target, max_size in ((32, None), (25, 30), (80, None)):
        want = jax_acp.resize_image_mask(image, mask, target, edge, max_size)
        got = acp.resize_image_mask(image, mask, target, edge, max_size)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(6))
def test_advanced_copy_paste_equals_jax(seed):
    rng = np.random.default_rng(seed)
    images, masks = [], []
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(40, 90, 2))
        images.append(rng.normal(size=(3, h, w)).astype(np.float32))
        m = np.zeros((h, w), np.int64)
        m[h // 4:h // 2 + rng.integers(1, h // 2),
          w // 5:w // 2 + rng.integers(1, w // 2)] = 1
        masks.append(m)
    cats = list(rng.integers(1, 9, 6))
    ours, theirs = acp.AdvancedCopyPaste(64, 4, 16), jax_acp.AdvancedCopyPaste(
        64, 4, 16)
    r1, r2 = rngs(seed)
    gj = theirs.generate_grid(r1, max_instances=6)
    gp = ours.generate_grid(r2, max_instances=6)
    assert gj == gp
    n, info, idx = gp
    want = theirs.copy_paste(r1, images[:n], masks[:n], cats[:n], info, idx)
    got = ours.copy_paste(r2, images[:n], masks[:n], cats[:n], info, idx)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    same_state(r1, r2)
