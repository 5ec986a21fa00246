"""Host-side training augmentations on HWC uint8 arrays (the port of
zutis_tpu/data/augment.py, without Pillow or OpenCV).

Each function draws from its `np.random.Generator` exactly as the JAX one
does, and gives its pixels bit for bit (tests/test_torch_augment.py):
  random_scale  — uniform scale in `scale_range`; the image through
      Pillow's BILINEAR resampler, the mask through its NEAREST one
      (data/transforms.py) (reference geometric_transforms.py:174-193).
  random_crop   — pad up to the crop size with the per-image mean (masks
      with ignore_index), the padding in one corner quadrant picked by the
      reference's non-uniform elif chain, then a random offset crop
      (geometric_transforms.py:10-54, base_dataset.py:36-53).
  random_hflip  — flips when random() > p, the reference's quirk.
  color_jitter  — ColorJitter(0.8, 0.8, 0.8, 0.2) in a random op order,
      with Pillow's arithmetic: ImageEnhance's Image.blend (float32,
      truncated), the L conversion (19595 R + 38470 G + 7471 B + 0x8000)
      >> 16, Contrast's rounded mean of L, and the hue shift through
      Pillow's rgb2hsv/hsv2rgb (native/image.cc).
  gaussian_blur — cv2.GaussianBlur's bit-exact 8-bit path with a kernel of
      ~10% of the shorter side and sigma U(0.1, 2), p = 0.5
      (native/image.cc; gaussian_blur.py:7-24).
  copy_paste    — objects 1..n pasted onto canvas 0 (copy_paste.py:16-57).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from zutis_tpu_torch.data.transforms import resize
from zutis_tpu_torch.native import image as native_image


def random_scale(
    rng: np.random.Generator,
    image: np.ndarray,
    scale_range: Tuple[float, float],
    mask: Optional[np.ndarray] = None,
):
    scale = rng.uniform(*scale_range)
    h, w = image.shape[:2]
    w_rs, h_rs = int(w * scale), int(h * scale)
    size = (max(w_rs, 1), max(h_rs, 1))
    image = resize(image, size, "bilinear")
    if mask is not None:
        mask = resize(mask.astype(np.int32), size, "nearest")
    return image, mask


def random_crop(
    rng: np.random.Generator,
    image: np.ndarray,
    crop_size: int,
    mask: Optional[np.ndarray] = None,
    ignore_index: int = 255,
):
    h, w = image.shape[:2]
    pad_h = max(crop_size - h, 0)
    pad_w = max(crop_size - w, 0)
    # padding goes entirely into one corner quadrant. The reference's
    # elif chain RE-DRAWS random() per comparison (geometric_transforms.py
    # :35-42), so the corners are NOT uniform: P = 0.25 / 0.1875 / 0.1406 /
    # 0.4219 for (left+top / left+bottom / top+right / right+bottom).
    if rng.random() < 0.25:
        pl, pt = pad_w, pad_h
    elif 0.25 <= rng.random() < 0.5:
        pl, pt = pad_w, 0
    elif 0.5 <= rng.random() < 0.75:
        pl, pt = 0, pad_h
    else:
        pl, pt = 0, 0
    pr, pb = pad_w - pl, pad_h - pt

    arr = np.array(image)
    fill = arr.mean(axis=(0, 1)).astype(np.uint8)
    arr = np.pad(arr, ((pt, pb), (pl, pr), (0, 0)), constant_values=0)
    if pad_h or pad_w:
        padded_region = np.ones(arr.shape[:2], bool)
        padded_region[pt:pt + h, pl:pl + w] = False
        arr[padded_region] = fill
    H, W = arr.shape[:2]
    oy = int(rng.integers(0, H - crop_size + 1))
    ox = int(rng.integers(0, W - crop_size + 1))
    arr = arr[oy:oy + crop_size, ox:ox + crop_size]

    if mask is not None:
        m = np.pad(mask, ((pt, pb), (pl, pr)), constant_values=ignore_index)
        mask = m[oy:oy + crop_size, ox:ox + crop_size]
    return np.ascontiguousarray(arr), mask


def random_hflip(
    rng: np.random.Generator,
    image: np.ndarray,
    p: float,
    mask: Optional[np.ndarray] = None,
):
    # reference quirk: flips when random() > p (probability 1 - p)
    if rng.random() > p:
        image = np.ascontiguousarray(image[:, ::-1])
        if mask is not None:
            mask = mask[:, ::-1].copy()
    return image, mask


def to_luma(image: np.ndarray) -> np.ndarray:
    """Pillow's RGB -> L: (19595 R + 38470 G + 7471 B + 0x8000) >> 16."""
    px = image.astype(np.int32)
    return ((px[..., 0] * 19595 + px[..., 1] * 38470 + px[..., 2] * 7471
             + 0x8000) >> 16).astype(np.uint8)


def _gray_rgb(image: np.ndarray) -> np.ndarray:
    return np.repeat(to_luma(image)[..., None], 3, axis=2)


def blend(degenerate: np.ndarray, image: np.ndarray,
          factor: float) -> np.ndarray:
    """Image.blend(degenerate, image, factor): in float32, truncated, and
    clipped when extrapolating (factor outside [0, 1])."""
    alpha = np.float32(factor)
    if alpha == 0.0:
        return np.broadcast_to(degenerate, image.shape).astype(np.uint8)
    if alpha == 1.0:
        return image.copy()
    in1 = np.broadcast_to(degenerate, image.shape).astype(np.float32)
    val = in1 + alpha * (image.astype(np.float32) - in1)
    if 0.0 <= alpha <= 1.0:
        return val.astype(np.uint8)
    return np.clip(val, 0.0, 255.0).astype(np.uint8)


def adjust_brightness(image: np.ndarray, factor: float) -> np.ndarray:
    return blend(np.zeros((), np.uint8), image, factor)


def adjust_contrast(image: np.ndarray, factor: float) -> np.ndarray:
    luma = to_luma(image)
    hist = np.bincount(luma.ravel(), minlength=256)
    mean = int(float(np.dot(np.arange(256), hist)) / luma.size + 0.5)
    return blend(np.full((), mean, np.uint8), image, factor)


def adjust_saturation(image: np.ndarray, factor: float) -> np.ndarray:
    return blend(_gray_rgb(image), image, factor)


def adjust_hue(image: np.ndarray, factor: float) -> np.ndarray:
    if factor == 0:
        return image
    return native_image.hue_shift(image, int(factor * 255))


def color_jitter(
    rng: np.random.Generator,
    image: np.ndarray,
    brightness: float = 0.8,
    contrast: float = 0.8,
    saturation: float = 0.8,
    hue: float = 0.2,
) -> np.ndarray:
    b = rng.uniform(max(0, 1 - brightness), 1 + brightness)
    c = rng.uniform(max(0, 1 - contrast), 1 + contrast)
    s = rng.uniform(max(0, 1 - saturation), 1 + saturation)
    h = rng.uniform(-hue, hue)
    ops = [
        lambda im: adjust_brightness(im, b),
        lambda im: adjust_contrast(im, c),
        lambda im: adjust_saturation(im, s),
        lambda im: adjust_hue(im, h),
    ]
    for i in rng.permutation(4):
        image = ops[i](image)
    return image


def gaussian_blur(
    rng: np.random.Generator,
    image: np.ndarray,
    p: float = 0.5,
    sigma_range: Tuple[float, float] = (0.1, 2.0),
) -> np.ndarray:
    if rng.random() >= p:
        return image
    h, w = image.shape[:2]
    k = int((0.1 * min(w, h)) // 2 * 2 + 1)
    sigma = rng.uniform(*sigma_range)
    return native_image.gaussian_blur(image, k, sigma)


def photometric_augmentations(
    rng: np.random.Generator,
    image: np.ndarray,
    jitter_p: float = 0.8,
    grayscale_p: float = 0.2,
    blur: bool = True,
) -> np.ndarray:
    if rng.random() < jitter_p:
        image = color_jitter(rng, image)
    if rng.random() < grayscale_p:
        image = _gray_rgb(image)
    if blur:
        image = gaussian_blur(rng, image)
    return image


def mask_to_bbox(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(ymin, ymax, xmin, xmax) of nonzero pixels, or (-1,)*4 when empty
    (reference copy_paste.py:6-13)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return -1, -1, -1, -1
    return int(ys.min()), int(ys.max()), int(xs.min()), int(xs.max())


def copy_paste(
    rng: np.random.Generator,
    images,  # list of [3, H, W] float arrays
    semantic_masks,  # list of [H, W] int arrays
    instance_masks,  # list of [H, W] int arrays
    background_index: int = 0,
    ignore_index: int = 255,
):
    """Sequentially paste objects 1..n onto canvas 0 at random offsets
    (reference copy_paste.py:16-57); the pasted region is the tight bbox of
    the object's mask, masked to object pixels."""
    out_img = images[0].copy()
    out_sem = semantic_masks[0].copy()
    out_inst = instance_masks[0].copy()
    H, W = out_sem.shape
    for img, sem, inst in zip(images[1:], semantic_masks[1:],
                              instance_masks[1:]):
        binary = (sem > background_index) & (sem < ignore_index)
        ymin, ymax, xmin, xmax = mask_to_bbox(binary)
        if ymin == -1:
            continue
        bh, bw = ymax - ymin, xmax - xmin
        region = binary[ymin:ymax, xmin:xmax]
        oy = int(rng.integers(0, H - bh + 1))
        ox = int(rng.integers(0, W - bw + 1))
        dst_img = out_img[:, oy:oy + bh, ox:ox + bw]
        dst_img[:, region] = img[:, ymin:ymax, xmin:xmax][:, region]
        out_sem[oy:oy + bh, ox:ox + bw][region] = \
            sem[ymin:ymax, xmin:xmax][region]
        out_inst[oy:oy + bh, ox:ox + bw][region] = \
            inst[ymin:ymax, xmin:xmax][region]
    return out_img, out_sem, out_inst
