"""Index-archive image embeddings (the port of
zutis_tpu/retrieval/image_embeddings.py).

Behavioural contract (reference utils/extract_image_embeddings.py:21-115):
batch-encode every image of an index archive (ImageNet2012-train, PASS)
with the CLIP retrieval encoder (ViT-L/14@336px), L2-normalise, and store a
{path: float32 embedding} pickle bank.

Images are decoded by the port's decoder in the file's own mode and
preprocessed on the host exactly as `clip_preprocess` does with Pillow
(data/image_io.py, data/transforms.py); the encoder runs `encode_image` on
its device in fixed-size batches (flash attention on the card), a short
last batch padded with copies of its last image.
"""
from __future__ import annotations

import pickle
from typing import Dict, List, Optional

import numpy as np
import torch

from zutis_tpu_torch.core.device import to_device
from zutis_tpu_torch.data.image_io import open_image, to_rgb
from zutis_tpu_torch.data.transforms import resize

# CLIP's published preprocessing constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _muldiv255(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tmp = a.astype(np.int32) * b + 128
    return ((tmp >> 8) + tmp) >> 8


def _premultiply(arr: np.ndarray) -> np.ndarray:
    """Pillow's LA -> La and RGBA -> RGBa (Convert.c, MULDIV255)."""
    alpha = arr[..., -1:].astype(np.int32)
    out = arr.copy()
    out[..., :-1] = _muldiv255(arr[..., :-1], alpha)
    return out


def _unpremultiply(arr: np.ndarray) -> np.ndarray:
    """Pillow's La -> LA and RGBa -> RGBA: 255 * c / alpha truncated and
    clipped, the colour kept where alpha is 0 or 255."""
    alpha = arr[..., -1:].astype(np.int32)
    colour = arr[..., :-1].astype(np.int32)
    scaled = np.minimum(255 * colour // np.maximum(alpha, 1), 255)
    keep = (alpha == 0) | (alpha == 255)
    out = arr.copy()
    out[..., :-1] = np.where(keep, colour, scaled)
    return out


def resize_bicubic_as_pillow(arr: np.ndarray, mode: str, size) -> np.ndarray:
    """`Image.resize(size, BICUBIC)` on an image of `mode`, in that mode:
    "1" and "P" resize with NEAREST, as Pillow does whatever the filter;
    "LA" and "RGBA" resize premultiplied by alpha; "L", "RGB" and "CMYK"
    band by band. `size` is (width, height)."""
    if mode in ("1", "P"):
        return resize(arr, size, "nearest")
    if mode in ("LA", "RGBA"):
        if tuple(size) == (arr.shape[1], arr.shape[0]):
            return arr.copy()
        return _unpremultiply(resize(_premultiply(arr), size, "bicubic"))
    if mode in ("L", "RGB", "CMYK"):
        return resize(arr, size, "bicubic")
    raise ValueError(f"no bicubic resize of mode {mode!r}")


def clip_preprocess(path, resolution: int) -> np.ndarray:
    """The image file at `path` -> [3, R, R] float32: the shorter side
    resized to `resolution` (bicubic, in the file's own mode), a centre
    crop, then RGB and CLIP's normalisation, as
    `pil.resize(...).crop(...).convert("RGB")` gives it. The size
    arithmetic is torchvision's (reference extract_image_embeddings.py:
    97-99): the long side truncates and the crop offset rounds."""
    arr, mode, palette = open_image(path)
    h, w = arr.shape[:2]
    if w <= h:
        new_w, new_h = resolution, int(resolution * h / w)
    else:
        new_w, new_h = int(resolution * w / h), resolution
    arr = resize_bicubic_as_pillow(arr, mode, (new_w, new_h))
    left = int(round((new_w - resolution) / 2.0))
    top = int(round((new_h - resolution) / 2.0))
    arr = arr[top:top + resolution, left:left + resolution]
    rgb = np.asarray(to_rgb(arr, mode, palette), np.float32) / 255.0
    rgb = (rgb - CLIP_MEAN) / CLIP_STD
    return np.ascontiguousarray(rgb.transpose(2, 0, 1))


def encode_images(p_images: List[str], visual_encoder, resolution: int = 336,
                  batch_size: Optional[int] = None) -> np.ndarray:
    """-> [n, output_dim] float32: the unnormalised `encode_image` of each
    image, in one batch padded to `batch_size` (if given) with copies of
    its last image. `visual_encoder` is the port's `CLIPViT` or
    `ModifiedResNet` (attnpool's lead token)."""
    arrs = [clip_preprocess(p, resolution) for p in p_images]
    pad = 0 if batch_size is None else batch_size - len(arrs)
    batch = torch.from_numpy(np.stack(arrs + [arrs[-1]] * pad))
    device = next(visual_encoder.parameters()).device
    with torch.no_grad():
        emb = visual_encoder.encode_image(to_device(batch, device))
    return emb[:len(arrs)].float().cpu().numpy()


def extract_image_embeddings(
    p_images: List[str],
    visual_encoder,
    resolution: int = 336,
    batch_size: int = 32,
    fp: Optional[str] = None,
) -> Dict[str, np.ndarray]:
    """-> {path: unit-norm float32 embedding} from the port's `CLIPViT` or
    `ModifiedResNet`;
    optionally pickled to `fp` in the reference bank format
    (extract_image_embeddings.py:21-86)."""
    out: Dict[str, np.ndarray] = {}
    for i in range(0, len(p_images), batch_size):
        chunk = p_images[i:i + batch_size]
        emb = encode_images(chunk, visual_encoder, resolution, batch_size)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        for p, e in zip(chunk, emb):
            out[p] = e
    if fp is not None:
        with open(fp, "wb") as f:
            pickle.dump(out, f)
    return out
