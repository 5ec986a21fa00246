"""Pseudo-masks for the retrieved images (the port of
zutis_tpu/data/pseudo_masks.py): SelfMask's best mask refined by the
bilateral solver, one COCO-RLE JSON per image.

For each image without a mask file (or every image, with `overwrite`):
decode (`data/image_io.py`), resize the shorter side to 512 with Pillow's
bilinear filter (`data/transforms.py`), normalise, zero-pad to a patch
multiple, `SelfMask.best_masks` on the device; the bilateral solver on the
same device over the resized image (`ops/bilateral.py`); the mask resized
back to the original size with Pillow's NEAREST filter on the uint8
`mask * 255` image and thresholded at 127; RLE-encoded to
`<dir_pseudo_masks>/<image-stem>.json` (or where `path_map` says), read
back and checked to decode to the same mask. The files are the JAX
package's byte for byte.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from zutis_tpu_torch.core.device import resolve_device, to_device
from zutis_tpu_torch.data.image_io import read_rgb
from zutis_tpu_torch.data.transforms import (normalize_image, resize,
                                             resize_edge)
from zutis_tpu_torch.models.selfmask import pad_to_patch_multiple
from zutis_tpu_torch.ops import rle
from zutis_tpu_torch.ops.bilateral import bilateral_solver_output


def pseudo_mask_path(dir_pseudo_masks: str, p_image: str) -> str:
    stem = os.path.splitext(os.path.basename(p_image))[0]
    return os.path.join(dir_pseudo_masks, f"{stem}.json")


def load_resized(p_image: str, image_size: int = 512
                 ) -> Tuple[Tuple[int, int], np.ndarray]:
    """-> (the image's (H, W), the image resized to `image_size` on its
    shorter side [h, w, 3] uint8)."""
    rgb = read_rgb(p_image)
    return rgb.shape[:2], resize_edge(rgb, image_size, edge="shorter")


def selfmask_mask(model, resized: np.ndarray, device) -> np.ndarray:
    """`SelfMask.best_masks` of one resized image -> [h, w] uint8."""
    arr = normalize_image(resized)[None]  # [1, 3, h, w]
    h, w = arr.shape[-2:]
    x = to_device(torch.from_numpy(
        pad_to_patch_multiple(arr, model.patch_size)), device)
    with torch.inference_mode():
        return model.best_masks(x)[0, :h, :w].cpu().numpy()


def to_original_size(mask: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Pillow's NEAREST resize of the uint8 `mask * 255` to (H, W), > 127."""
    back = resize(mask.astype(np.uint8) * 255, (size[1], size[0]), "nearest")
    return (back > 127).astype(np.uint8)


def write_mask(mask: np.ndarray, p_mask: str) -> None:
    """RLE JSON of `mask` to `p_mask`, read back and checked."""
    with open(p_mask, "w") as f:
        json.dump(rle.encode(mask), f)
    with open(p_mask) as f:
        roundtrip = rle.decode(json.load(f))
    if not np.array_equal(roundtrip, mask):
        raise RuntimeError(f"RLE round trip of {p_mask} differs from the mask")


def generate_pseudo_masks(
    p_images: List[str],
    dir_pseudo_masks: str,
    model,
    image_size: int = 512,
    use_bilateral_solver: bool = True,
    overwrite: bool = False,
    path_map: Optional[Dict[str, str]] = None,
    device="cuda",
) -> Dict[str, str]:
    """Returns {p_image: p_pseudo_mask_json}, writing the missing files.
    `model` is a `SelfMask` with its weights on `device`; `path_map`
    overrides the flat `<dir>/<stem>.json` layout per image (ImageNet's
    `{split}_pseudo_masks_selfmask/{wnid}/`, data/imagenet_index.py)."""
    device = resolve_device(device)
    on = next(model.parameters()).device
    if on.type != device.type:
        raise ValueError(f"the SelfMask model lies on {on}, not on {device}")
    out: Dict[str, str] = {}
    for p_image in p_images:
        p_mask = (path_map[p_image] if path_map is not None
                  else pseudo_mask_path(dir_pseudo_masks, p_image))
        os.makedirs(os.path.dirname(p_mask) or ".", exist_ok=True)
        out[p_image] = p_mask
        if os.path.exists(p_mask) and not overwrite:
            continue
        size, resized = load_resized(p_image, image_size)
        mask = selfmask_mask(model, resized, device)
        if use_bilateral_solver:
            _, refined = bilateral_solver_output(
                resized, mask.astype(np.float64), device=device)
            mask = refined.astype(np.uint8)
        write_mask(to_original_size(mask, size), p_mask)
    return out
