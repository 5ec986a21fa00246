"""The ImageNet-1K index dataset (the port of `ImageNet1KDataset`,
`imagenet_pseudo_mask_path` and `imagenet_filename_to_path` from
zutis_tpu/data/imagenet_index.py).

ImageNet1KDataset (reference datasets/imagenet.py:23-404): retrieved
images keyed by category, pseudo-masks at
`{dir}/{split}_pseudo_masks_selfmask/{wnid}/{name}.json` (:107-113),
synthesis with NO random scaling (random_scale_range=(1,1), :330-337) and
an optional grid-partition "advanced copy-paste" mode (:276-313). Every
sample is a pure function of (seed, epoch, index), as in IndexDataset.

The port reads the category -> image paths mapping from its JSON cache
only. Retrieving it over the CLIP embedding bank, the PASS archive and the
combined ImageNet + PASS retrieval are not ported yet (ROADMAP.md, queue 1,
item 8): without the cache the constructor raises NotImplementedError.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from zutis_tpu_torch.data.index_dataset import IndexDataset


def imagenet_pseudo_mask_path(dir_dataset: str, p_image: str) -> str:
    """reference datasets/imagenet.py:107-113."""
    split, wnid, filename = p_image.split("/")[-3:]
    stem = os.path.splitext(filename)[0]
    return f"{dir_dataset}/{split}_pseudo_masks_selfmask/{wnid}/{stem}.json"


def imagenet_filename_to_path(dir_dataset: str, filename: str,
                              split: str = "train") -> str:
    """ImageNet train files are `<wnid>_<i>.JPEG` under their wnid directory
    (reference datasets/imagenet.py:236-240)."""
    wnid = filename.split("_")[0]
    return f"{dir_dataset}/{split}/{wnid}/{filename}"


class ImageNet1KDataset(IndexDataset):
    name = "imagenet"

    def __init__(
        self,
        dir_dataset: str,
        categories: List[str],
        ignore_index: int = 255,
        category_to_p_images_fp: Optional[str] = None,
        cat_to_text_embedding: Optional[Dict[str, np.ndarray]] = None,
        n_images: int = 500,
        max_n_masks: int = 10,
        split: str = "train",
        scale_range=(1.0, 1.0),  # the reference pastes UNscaled objects
        image_size: int = 384,
        use_advanced_copy_paste: bool = False,
        max_n_partitions: int = 4,
        min_distance: int = 48,
        seed: int = 0,
    ):
        cat_to_p_images = self._resolve_categories(category_to_p_images_fp)
        p_image_to_p_pseudo_mask = {
            p: imagenet_pseudo_mask_path(dir_dataset, p)
            for ps in cat_to_p_images.values() for p in ps
        }
        super().__init__(
            categories=categories,
            category_to_p_images=cat_to_p_images,
            p_image_to_p_pseudo_mask=p_image_to_p_pseudo_mask,
            image_size=image_size,
            ignore_index=ignore_index,
            scale_range=scale_range,
            max_n_masks=max_n_masks,
            random_duplicate=False,
            seed=seed,
            use_advanced_copy_paste=use_advanced_copy_paste,
            max_n_partitions=max_n_partitions,
            min_distance=min_distance,
        )
        self.dir_dataset = dir_dataset

    @staticmethod
    def _resolve_categories(category_to_p_images_fp) -> Dict[str, List[str]]:
        if category_to_p_images_fp and os.path.exists(
                category_to_p_images_fp):
            with open(category_to_p_images_fp) as f:
                return json.load(f)
        raise NotImplementedError(
            f"no category_to_p_images cache at {category_to_p_images_fp!r}: "
            "retrieving images over the CLIP embedding bank is not ported "
            "yet (ROADMAP.md, queue 1, item 8); write the cache with the "
            "JAX package first")

    def missing_pseudo_masks(self) -> List[str]:
        return [p for p, pm in self.p_image_to_p_pseudo_mask.items()
                if not os.path.exists(pm)]
