"""Minimal COCO annotation index (the port's copy of
zutis_tpu/data/coco_api.py): image listing, per-image annotations and
annotation -> binary mask (polygons or RLE, through the port's ops/rle)."""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List, Union

import numpy as np

from zutis_tpu_torch.ops import rle as rle_ops


class COCOIndex:
    def __init__(self, annotations: Union[str, dict]):
        if isinstance(annotations, str):
            with open(annotations) as f:
                annotations = json.load(f)
        self.dataset = annotations
        self.imgs: Dict[int, dict] = {
            im["id"]: im for im in annotations.get("images", [])
        }
        self.cats: Dict[int, dict] = {
            c["id"]: c for c in annotations.get("categories", [])
        }
        self.img_to_anns: Dict[int, List[dict]] = defaultdict(list)
        self.anns: Dict[int, dict] = {}
        for ann in annotations.get("annotations", []):
            self.img_to_anns[ann["image_id"]].append(ann)
            self.anns[ann["id"]] = ann

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs)

    def load_img(self, image_id: int) -> dict:
        return self.imgs[image_id]

    def load_anns(self, image_id: int) -> List[dict]:
        return self.img_to_anns.get(image_id, [])

    def ann_to_mask(self, ann: dict) -> np.ndarray:
        img = self.imgs[ann["image_id"]]
        return rle_ops.segmentation_to_mask(
            ann["segmentation"], img["height"], img["width"]
        )
