"""COCO label-id maps and palettes (the port's copy of
zutis_tpu/data/label_maps.py).

COCO's 91 original category ids have 10 unused slots; the reference
(datasets/coco2017.py:152-245) maps them to 80 contiguous ids (+background).
The removed original ids are a fixed property of the COCO dataset, so the
mapping is derived programmatically here rather than tabulated."""
from __future__ import annotations

from typing import Dict, List

import numpy as np

# original COCO category ids withdrawn from the released dataset
_REMOVED_COCO_IDS = {12, 26, 29, 30, 45, 66, 68, 69, 71, 83}


def _build_maps():
    old_to_new: Dict[int, int] = {0: 0}
    new = 1
    for old in range(1, 91):
        if old in _REMOVED_COCO_IDS:
            continue
        old_to_new[old] = new
        new += 1
    return old_to_new


old_label_id_to_new_label_id: Dict[int, int] = _build_maps()
new_label_id_to_old_label_id: Dict[int, int] = {
    v: k for k, v in old_label_id_to_new_label_id.items()
}


def pascal_colormap(n: int = 512) -> np.ndarray:
    """PASCAL VOC bit-twiddled label colormap (reference coco2017.py:249-272)."""
    colormap = np.zeros((n, 3), dtype=int)
    ind = np.arange(n, dtype=int)
    for shift in reversed(range(8)):
        for channel in range(3):
            colormap[:, channel] |= ((ind >> channel) & 1) << shift
        ind >>= 3
    return colormap


def get_palette(n_categories: int = 512) -> np.ndarray:
    palette = pascal_colormap(max(n_categories, 256))
    if len(palette) > 255:
        palette[255] = np.array([255, 255, 255])  # ignore index -> white
    return palette


def label_id_to_category_from_list(categories: List[str]) -> Dict[int, str]:
    """new label id -> name, from a config's (background-first) category list."""
    return dict(enumerate(categories))
