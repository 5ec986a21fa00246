"""Grid-partition copy-paste synthesis ("advanced copy-paste").

Behavioural contract (reference datasets/augmentations/advanced_copy_paste.py
:16-283): partition the square training canvas with randomly-placed
horizontal/vertical bars (each at least `min_distance` from previous bars,
:35-50,52-99), choose a random subset of the resulting cells (:101-117), and
paste one pseudo-masked object per chosen cell — cropped to its mask bbox and
resized aspect-preserving so the bbox fits the cell (:135-237) — onto a
background object image; non-object background pixels are replaced by the
mean of object pixels (:265-269). Outputs image, semantic mask and per-
instance binary masks.

The port of zutis_tpu/data/advanced_copy_paste.py: host-side numpy, with
`resize_image_mask` on the port's copies of Pillow's float32 ("F") BILINEAR
and uint8 NEAREST resamplers (data/transforms.py), so that it gives the JAX
module's arrays bit for bit. Delta from the reference: all randomness
flows through an explicit `np.random.Generator` and grid state is
returned, not stored on the object, so sample `t` stays a pure function of
(seed, t) for checkpoint-exact resume (SURVEY.md section 5
failure-recovery row).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from zutis_tpu_torch.data.augment import mask_to_bbox
from zutis_tpu_torch.data.transforms import resize


def _resize_hw(h: int, w: int, size: int, edge: str,
               max_size: Optional[int] = None) -> Tuple[int, int]:
    """Target (h, w) for torch-style edge resize semantics (reference
    datasets/augmentations/geometric_transforms.py:85-171)."""
    if edge == "both":
        return size, size
    if edge == "shorter":
        if h <= w:
            nh, nw = size, max(1, round(w * size / h))
        else:
            nh, nw = max(1, round(h * size / w)), size
        if max_size is not None:
            if nh > nw and nh > max_size:
                nw = max(1, round(nw * max_size / nh))
                nh = max_size
            elif nw >= nh and nw > max_size:
                nh = max(1, round(nh * max_size / nw))
                nw = max_size
        return nh, nw
    if edge == "longer":
        if h >= w:
            return size, max(1, round(w * size / h))
        return max(1, round(h * size / w)), size
    raise ValueError(edge)


def resize_image_mask(
    image: np.ndarray,  # [3, h, w] float
    mask: np.ndarray,  # [h, w] int
    size: int,
    edge: str,
    max_size: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    h, w = mask.shape
    nh, nw = _resize_hw(h, w, size, edge, max_size)
    img = np.stack([resize(c, (nw, nh), "bilinear")
                    for c in image.astype(np.float32)])
    m = resize(mask.astype(np.uint8), (nw, nh), "nearest").astype(mask.dtype)
    return img, m


class AdvancedCopyPaste:
    def __init__(self, grid_size: int = 384, max_n_partitions: int = 4,
                 min_distance: int = 48):
        self.grid_size = grid_size
        self.max_n_partitions = max_n_partitions
        self.min_distance = min_distance

    @staticmethod
    def select_new_bar(rng: np.random.Generator, prev_bars, min_distance: int,
                       max_length: int) -> int:
        occupied: set = set()
        for bar in prev_bars:
            occupied.update(range(bar - min_distance, bar + min_distance))
        candidates = sorted(set(range(max_length)) - occupied)
        if not candidates:
            return 0
        return int(candidates[int(rng.integers(0, len(candidates)))])

    def partition_grid(
        self, rng: np.random.Generator,
        n_partitions: Tuple[int, int], min_distance: int,
    ) -> Dict[int, Dict[str, int]]:
        h = w = self.grid_size
        n_x, n_y = n_partitions
        vertical = {0, w + 1}
        for _ in range(n_x):
            vertical.add(self.select_new_bar(rng, vertical, min_distance, w))
        vertical.discard(w + 1)
        vertical.add(w)
        vertical = sorted(vertical)
        horizontal = {0, h + 1}
        for _ in range(n_y):
            horizontal.add(
                self.select_new_bar(rng, horizontal, min_distance, h))
        horizontal.discard(h + 1)
        horizontal.add(h)
        horizontal = sorted(horizontal)

        patch_info: Dict[int, Dict[str, int]] = {}
        idx = 0
        for i in range(len(horizontal) - 1):
            for j in range(len(vertical) - 1):
                patch_info[idx] = {
                    "top": horizontal[i], "left": vertical[j],
                    "height": horizontal[i + 1] - horizontal[i],
                    "width": vertical[j + 1] - vertical[j],
                }
                idx += 1
        return patch_info

    def generate_grid(self, rng: np.random.Generator,
                      max_instances: Optional[int] = None):
        """-> (n_images_needed, patch_info, patch_indices). The first image
        is always the background object (reference :101-117).
        `max_instances` caps pasted objects + background at the caller's
        instance-mask slot count: without it a large grid could paste more
        objects than the fixed-shape GT tensors can carry, silently
        dropping GT rows for painted pixels (their pixels would stay in
        the image/semantic mask with no mask-loss row). Capping here keeps
        image content and GT slots consistent; the RNG draw order is
        unchanged."""
        if self.max_n_partitions == 1:
            return 1, {}, []
        n_x = int(rng.integers(1, self.max_n_partitions))
        n_y = int(rng.integers(1, self.max_n_partitions))
        patch_info = self.partition_grid(
            rng, (n_x, n_y), self.grid_size // self.max_n_partitions)
        n_random = int(rng.integers(0, len(patch_info)))
        patch_indices = list(
            rng.choice(len(patch_info), size=n_random, replace=False))
        if max_instances is not None:
            n_random = min(n_random, max_instances - 1)
            patch_indices = patch_indices[:n_random]
        return n_random + 1, patch_info, [int(i) for i in patch_indices]

    def _fit_to_patch(self, image, mask, h_patch, w_patch):
        """Aspect-preserving resize of an object bbox into a grid cell
        (reference :176-237's edge-case table)."""
        h_img, w_img = mask.shape
        if h_patch < w_patch:
            if h_img < w_img:
                return resize_image_mask(image, mask, h_patch, "shorter",
                                         max_size=w_patch)
            if h_img > w_img:
                return resize_image_mask(image, mask, h_patch, "longer")
            return resize_image_mask(image, mask, h_patch, "both")
        if h_patch > w_patch:
            if h_img < w_img:
                return resize_image_mask(image, mask, w_patch, "longer")
            if h_img > w_img:
                return resize_image_mask(image, mask, w_patch, "shorter",
                                         max_size=h_patch)
            return resize_image_mask(image, mask, w_patch, "both")
        return resize_image_mask(image, mask, h_patch, "longer")

    def copy_paste(
        self,
        rng: np.random.Generator,
        images: Sequence[np.ndarray],  # each [3, h, w] float
        binary_masks: Sequence[np.ndarray],  # each [h, w] in {0, 1}
        category_ids: Sequence[int],
        patch_info: Dict[int, Dict[str, int]],
        patch_indices: List[int],
    ) -> Dict[str, np.ndarray]:
        S = self.grid_size
        # reference :128-138: background resized by the SHORTER edge (no
        # aspect distortion), then image and mask share one random SxS crop
        # (the shorter edge equals S after the resize, so no padding arises
        # and the crop offset is the only randomness)
        bg_img, bg_mask = resize_image_mask(
            images[0], binary_masks[0], S, "shorter")
        h_bg, w_bg = bg_img.shape[-2:]
        oy = int(rng.integers(0, h_bg - S + 1))
        ox = int(rng.integers(0, w_bg - S + 1))
        bg_img = bg_img[:, oy:oy + S, ox:ox + S]
        bg_mask = bg_mask[oy:oy + S, ox:ox + S]
        bg_mask = bg_mask.astype(np.int64)
        semantic = bg_mask * int(category_ids[0])

        n_instances = 1
        inst_category_ids = [int(category_ids[0])]
        for obj_i, patch_index in enumerate(patch_indices):
            image, mask = images[1 + obj_i], binary_masks[1 + obj_i]
            ymin, ymax, xmin, xmax = mask_to_bbox(mask)
            if (ymin, ymax, xmin, xmax) == (-1, -1, -1, -1):
                continue
            image = image[:, ymin:ymax, xmin:xmax]
            mask = mask[ymin:ymax, xmin:xmax]
            if 0 in mask.shape:
                continue
            info = patch_info[patch_index]
            top, left = info["top"], info["left"]
            h_patch, w_patch = info["height"], info["width"]
            if h_patch < 1 or w_patch < 1:
                continue
            image, mask = self._fit_to_patch(image, mask, h_patch, w_patch)
            h_bbox, w_bbox = mask.shape
            if h_bbox > h_patch or w_bbox > w_patch or 0 in mask.shape:
                continue
            n_instances += 1
            off_top = top + int(rng.integers(0, h_patch - h_bbox + 1))
            off_left = left + int(rng.integers(0, w_patch - w_bbox + 1))
            m = mask.astype(bool)
            region = (slice(off_top, off_top + h_bbox),
                      slice(off_left, off_left + w_bbox))
            bg_img[:, region[0], region[1]][:, m] = image[:, m]
            bg_mask[region][m] = n_instances
            semantic[region][m] = int(category_ids[1 + obj_i])
            inst_category_ids.append(int(category_ids[1 + obj_i]))

        if (bg_mask == 0).any() and (bg_mask > 0).any():
            # background regions take the mean object colour (reference
            # :265-269)
            mean = bg_img[:, bg_mask > 0].mean(axis=1, keepdims=True)
            bg_img[:, bg_mask == 0] = mean

        instance = np.stack(
            [bg_mask == i for i in range(1, n_instances + 1)], axis=0)
        return {
            "image": bg_img,
            "semantic_mask": semantic,
            "instance_mask": instance.astype(np.float32),
            "n_instances": n_instances,
            # category id per ACTUALLY-pasted instance (slot k of
            # instance_mask), so callers never reconstruct them positionally
            # from patch order — objects skipped by the continue paths above
            # would misalign that reconstruction (ADVICE r2)
            "instance_category_ids": np.asarray(inst_category_ids, np.int32),
        }
