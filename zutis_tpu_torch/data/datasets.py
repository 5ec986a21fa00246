"""Evaluation datasets: COCO2017-val, COCO-20K, CoCA, ImageNet-S.

Behavioural contracts (SURVEY.md section 2 inventory):
  COCO2017Dataset   — reference datasets/coco2017.py: val2017 images +
      instances_val2017.json; images ImageNet-normalised at native size
      (bs=1 eval); semantic GT from the pre-rendered PNG when present,
      otherwise rendered from instance annotations with the old->new 81-way
      label map (larger instances painted first so small objects stay
      visible).
  COCO20KDataset    — reference datasets/coco20k.py: 19,817 COCO2014-train
      images listed in LOST's coco_20k_filenames.txt; builds
      instances_train2014_sel20k.json on first use.
  COCADataset       — reference datasets/coca.py: binary masks; the category
      label id comes from the sorted list of category directory names
      (background = 0).
  ImageNetSDataset  — reference datasets/imagenet_s.py: 50/300/919 splits,
      longer edge capped at 1024, GT encoded as R + G*256, ignore index 1000,
      original size kept for final upsampling.

The port of zutis_tpu/data/datasets.py: images are decoded by the port's
JPEG/PNG decoder (data/image_io.py) and resized by its copy of Pillow's
resampler (data/transforms.py), so every item equals the JAX dataset's
(tests/test_torch_eval_datasets.py). All return numpy dicts.
"""
from __future__ import annotations

import json
import os
from glob import glob
from typing import Dict, List, Optional

import numpy as np

from zutis_tpu_torch.data.coco_api import COCOIndex
from zutis_tpu_torch.data.image_io import read_png, read_rgb
from zutis_tpu_torch.data.label_maps import old_label_id_to_new_label_id
from zutis_tpu_torch.data.transforms import normalize_image, resize_edge


class COCO2017Dataset:
    name = "coco2017"
    n_categories = 81
    ignore_index = 255

    def __init__(self, dir_dataset: str, split: str = "val"):
        self.dir_dataset = dir_dataset
        self.split = split
        self.p_annotations = (
            f"{dir_dataset}/annotations/instances_{split}2017.json"
        )
        self.coco = COCOIndex(self.p_annotations)
        self.image_ids: List[int] = self.coco.get_img_ids()

    def __len__(self) -> int:
        return len(self.image_ids)

    def _image_path(self, image_id: int) -> str:
        info = self.coco.load_img(image_id)
        return f"{self.dir_dataset}/{self.split}2017/{info['file_name']}"

    def _semantic_mask(self, image_id: int, filename: str) -> np.ndarray:
        p_png = (f"{self.dir_dataset}/annotations/"
                 f"semantic_segmentation_masks/{filename}.png")
        if os.path.exists(p_png):
            return read_png(p_png).astype(np.int32)
        # render from instance annotations: larger instances first
        info = self.coco.load_img(image_id)
        sem = np.zeros((info["height"], info["width"]), np.int32)
        anns = sorted(self.coco.load_anns(image_id),
                      key=lambda a: -a.get("area", 0))
        for ann in anns:
            m = self.coco.ann_to_mask(ann)
            sem[m > 0] = old_label_id_to_new_label_id[ann["category_id"]]
        return sem

    def __getitem__(self, index: int) -> Dict:
        image_id = self.image_ids[index]
        p_image = self._image_path(image_id)
        image = read_rgb(p_image)
        filename = os.path.basename(p_image).split(".jpg")[0]
        anns = self.coco.load_anns(image_id)
        instance_masks = (
            np.stack([self.coco.ann_to_mask(a) for a in anns])
            if anns else None
        )
        return {
            "image": normalize_image(image),
            "semantic_mask": self._semantic_mask(image_id, filename),
            "instance_mask": instance_masks,
            "category_ids": [a["category_id"] for a in anns],
            "filename": filename,
            "p_image": p_image,
            "image_id": image_id,
            "image_size": image.shape[:2],
        }


class COCO20KDataset:
    name = "coco20k"
    n_categories = 81
    ignore_index = 255

    def __init__(self, dir_dataset: str):
        self.dir_dataset = dir_dataset
        self.p_annotations = (
            f"{dir_dataset}/annotations/instances_train2014_sel20k.json"
        )
        if not os.path.exists(self.p_annotations):
            self._build_sel20k()
        self.coco = COCOIndex(self.p_annotations)
        self.image_ids = self.coco.get_img_ids()

    def _build_sel20k(self) -> None:
        p_names = f"{self.dir_dataset}/coco_20k_filenames.txt"
        p_all = f"{self.dir_dataset}/annotations/instances_train2014.json"
        assert os.path.exists(p_names), p_names
        assert os.path.exists(p_all), p_all
        with open(p_all) as f:
            train2014 = json.load(f)
        with open(p_names) as f:
            keep_ids = {
                int(line.strip().split("_")[-1].split(".")[0])
                for line in f if line.strip()
            }
        out = {
            "images": [im for im in train2014["images"]
                       if im["id"] in keep_ids],
            "annotations": [a for a in train2014["annotations"]
                            if a["image_id"] in keep_ids],
            "categories": train2014["categories"],
        }
        with open(self.p_annotations, "w") as f:
            json.dump(out, f)

    def __len__(self) -> int:
        return len(self.image_ids)

    def _image_path(self, image_id: int) -> str:
        info = self.coco.load_img(image_id)
        return f"{self.dir_dataset}/images/{info['file_name']}"

    def __getitem__(self, index: int) -> Dict:
        image_id = self.image_ids[index]
        p_image = self._image_path(image_id)
        image = read_rgb(p_image)
        return {
            "image": normalize_image(image),
            "image_id": image_id,
            "p_image": p_image,
            "image_size": image.shape[:2],
        }


class COCADataset:
    name = "coca"
    n_categories = 81
    ignore_index = 255

    def __init__(self, dir_dataset: str):
        self.dir_dataset = dir_dataset
        self.p_images = sorted(glob(f"{dir_dataset}/image/**/*.jpg"))
        self.p_gts = sorted(glob(f"{dir_dataset}/binary/**/*.png"))
        assert len(self.p_images) == len(self.p_gts) and self.p_images
        categories = sorted({p.split("/")[-2] for p in self.p_gts})
        self.category_to_label_id = {
            c: i for i, c in enumerate(categories, start=1)
        }

    def __len__(self) -> int:
        return len(self.p_images)

    def __getitem__(self, index: int) -> Dict:
        p_image, p_gt = self.p_images[index], self.p_gts[index]
        label_id = self.category_to_label_id[p_gt.split("/")[-2]]
        image = read_rgb(p_image)
        gt = read_png(p_gt).astype(np.int32)
        gt[gt == 255] = label_id
        return {
            "image": normalize_image(image),
            "semantic_mask": gt,
            "p_image": p_image,
            "p_semantic_mask": p_gt,
            "image_size": image.shape[:2],
        }


class ImageNetSDataset:
    ignore_index = 1000
    max_size = 1024

    def __init__(self, dir_dataset: str, n_categories: int,
                 split: str = "val"):
        assert n_categories in (50, 300, 919), n_categories
        split = "validation" if split == "val" else split
        self.split = split
        self.name = f"imagenet-s{n_categories}"
        base = f"{dir_dataset}/ImageNetS{n_categories}"
        self.p_images = sorted(glob(f"{base}/{split}/**/*.JPEG"))
        assert self.p_images, f"no images under {base}/{split}"
        if split == "validation":
            self.p_gts = sorted(glob(f"{base}/{split}-segmentation/**/*.png"))
            assert len(self.p_images) == len(self.p_gts)
        elif split == "train":
            self.p_gts = sorted(
                glob(f"{base}/{split}-semi-segmentation/**/*.png"))
            assert len(self.p_images) == len(self.p_gts)
        else:
            self.p_gts = None
        self.n_categories = n_categories + 1

    def __len__(self) -> int:
        return len(self.p_images)

    def __getitem__(self, index: int) -> Dict:
        p_image = self.p_images[index]
        image = read_rgb(p_image)
        H, W = image.shape[:2]
        if max(H, W) > self.max_size:
            image = resize_edge(image, self.max_size, edge="longer")
        out: Dict = {
            "image": normalize_image(image),
            "p_image": p_image,
            "original_size": (H, W),
        }
        if self.p_gts is not None:
            gt = read_png(self.p_gts[index]).astype(np.int64)
            gt = gt[..., 0] + gt[..., 1] * 256
            out["semantic_mask"] = gt
            out["p_gt"] = self.p_gts[index]
        return out


def get_eval_dataset(
    dataset_name: str,
    dir_dataset: str,
    split: str = "val",
    n_categories: Optional[int] = None,
):
    """Factory mirroring the reference's get_dataset dispatch
    (utils/utils.py:18-92) for the evaluation datasets."""
    if dataset_name == "coco2017":
        return COCO2017Dataset(dir_dataset, split=split)
    if dataset_name == "coco20k":
        return COCO20KDataset(dir_dataset)
    if dataset_name == "coca":
        return COCADataset(dir_dataset)
    if dataset_name == "imagenet-s":
        assert n_categories is not None
        return ImageNetSDataset(dir_dataset, n_categories - 1, split=split)
    raise ValueError(f"unknown dataset: {dataset_name}")
