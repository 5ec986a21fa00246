"""Where a retrieved image's pseudo-mask lives (the port's copy of
`pseudo_mask_path` from zutis_tpu/data/pseudo_masks.py): one COCO-RLE JSON
per image, `<dir_pseudo_masks>/<image-stem>.json`.

Generating missing pseudo-masks (SelfMask inference and the bilateral
solver) is not ported yet (ROADMAP.md, queue 1, item 8); the CLI raises on
a missing mask.
"""
from __future__ import annotations

import os


def pseudo_mask_path(dir_pseudo_masks: str, p_image: str) -> str:
    stem = os.path.splitext(os.path.basename(p_image))[0]
    return os.path.join(dir_pseudo_masks, f"{stem}.json")
