"""ImageNet-1K and PASS index-dataset variants (the port of
zutis_tpu/data/imagenet_index.py).

Behavioural contracts:
  - ImageNet1KDataset (reference datasets/imagenet.py:23-404): retrieval
    from the single ImageNet embedding bank (wnid derived from the
    filename, :189-244), pseudo-masks at
    `{dir}/{split}_pseudo_masks_selfmask/{wnid}/{name}.json` (:107-113),
    synthesis with NO random scaling (random_scale_range=(1,1), :330-337)
    and an optional grid-partition "advanced copy-paste" mode (:276-313).
  - PASS (reference datasets/pass.py:22-248): an unlabeled 1.44M-image
    archive; retrieval against its embedding bank, extracting the bank
    with the CLIP image encoder when missing (:84-142), and a flat
    pseudo-mask cache. PASS has no categories of its own: retrieved images
    inherit the query category, and `combined_retrieval` concatenates its
    bank with ImageNet's before the one retrieval product (the reference's
    index_dataset.py:138-158).

Retrieval runs on one device, or with `mesh=` over a mesh's data axis,
the bank's rows split over its ranks (retrieval/bank.py::topk_sharded).
Every sample is a pure function of (seed, epoch, index), as in
IndexDataset.
"""
from __future__ import annotations

import json
import os
import pickle
from glob import glob
from typing import Dict, List, Optional, Sequence

import numpy as np

from zutis_tpu_torch.data.index_dataset import IndexDataset
from zutis_tpu_torch.retrieval.bank import (load_bank_pkl,
                                            retrieve_category_paths)


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
        mesh=None,
        device="cuda",
    ):
        cat_to_p_images = self._resolve_categories(
            dir_dataset, category_to_p_images_fp, cat_to_text_embedding,
            n_images, split, mesh, device)
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
    def _resolve_categories(
        dir_dataset, category_to_p_images_fp, cat_to_text_embedding,
        n_images, split, mesh, device,
    ) -> Dict[str, List[str]]:
        """The JSON cache if it exists; else the top `n_images` of the
        split's bank for each category but "background", written to the
        cache."""
        if category_to_p_images_fp and os.path.exists(
                category_to_p_images_fp):
            with open(category_to_p_images_fp) as f:
                return json.load(f)
        if cat_to_text_embedding is None:
            raise ValueError(
                "no category_to_p_images cache and no text embeddings to "
                "retrieve with")
        bank_fp = (f"{dir_dataset}/filename_to_ViT_L_14_336px_{split}"
                   f"_img_embedding.pkl")
        bank, filenames = load_bank_pkl([bank_fp])
        wanted = {c: e for c, e in cat_to_text_embedding.items()
                  if c != "background"}
        by_name = retrieve_category_paths(
            wanted, bank, filenames, n_images, mesh=mesh, device=device)
        out = {
            c: [imagenet_filename_to_path(dir_dataset, fn, split)
                for fn in fns]
            for c, fns in by_name.items()
        }
        if category_to_p_images_fp:
            with open(category_to_p_images_fp, "w") as f:
                json.dump(out, f)
        return out

    def missing_pseudo_masks(self) -> List[str]:
        return [p for p, pm in self.p_image_to_p_pseudo_mask.items()
                if not os.path.exists(pm)]


class PASS:
    """PASS archive helper: retrieval bank management + pseudo-mask paths
    (reference datasets/pass.py:22-248). Produces the category -> paths and
    image -> pseudo-mask mappings that IndexDataset consumes."""

    def __init__(self, dir_dataset: str,
                 bank_name: str = "filename_to_ViT_L_14_336px"
                               "_img_embedding.pkl"):
        self.dir_dataset = dir_dataset
        self.bank_fp = os.path.join(dir_dataset, bank_name)
        self.dir_images = os.path.join(dir_dataset, "images")
        self.dir_pseudo = os.path.join(dir_dataset, "pseudo_masks_selfmask")

    def image_paths(self) -> List[str]:
        return sorted(glob(f"{self.dir_images}/**/*.jpg", recursive=True))

    def ensure_bank(self, encode_fn=None, batch_size: int = 256) -> str:
        """Extract the CLIP image-embedding bank when missing (reference
        pass.py:96-142). `encode_fn(list_of_paths) -> [n, d]` is the
        caller's CLIP pooled-embedding function, e.g.
        `functools.partial(retrieval.image_embeddings.encode_images,
        visual_encoder=encoder)`. Keys are paths relative to `images/`:
        PASS extracts into part subdirectories (images/0/x.jpg), where
        basenames collide across parts."""
        if os.path.exists(self.bank_fp):
            return self.bank_fp
        if encode_fn is None:
            raise ValueError(f"no embedding bank at {self.bank_fp}; pass "
                             "encode_fn to build it")
        paths = self.image_paths()
        bank: Dict[str, np.ndarray] = {}
        for s in range(0, len(paths), batch_size):
            chunk = paths[s:s + batch_size]
            embs = np.asarray(encode_fn(chunk), np.float32)
            embs /= np.linalg.norm(embs, axis=1, keepdims=True) + 1e-12
            for p, e in zip(chunk, embs):
                bank[os.path.relpath(p, self.dir_images)] = e
        with open(self.bank_fp, "wb") as f:
            pickle.dump(bank, f)
        return self.bank_fp

    def retrieve_images(
        self,
        cat_to_text_embedding: Dict[str, np.ndarray],
        n_images: int = 500,
        cache_fp: Optional[str] = None,
        mesh=None,
        device="cuda",
    ) -> Dict[str, List[str]]:
        if cache_fp and os.path.exists(cache_fp):
            with open(cache_fp) as f:
                return json.load(f)
        bank, filenames = load_bank_pkl([self.bank_fp])
        wanted = {c: e for c, e in cat_to_text_embedding.items()
                  if c != "background"}
        by_name = retrieve_category_paths(
            wanted, bank, filenames, n_images, mesh=mesh, device=device)
        out = {
            c: [os.path.join(self.dir_images, fn) for fn in fns]
            for c, fns in by_name.items()
        }
        if cache_fp:
            with open(cache_fp, "w") as f:
                json.dump(out, f)
        return out

    def pseudo_mask_paths(
        self, category_to_p_images: Dict[str, List[str]]
    ) -> Dict[str, str]:
        out = {}
        for ps in category_to_p_images.values():
            for p in ps:
                stem = os.path.splitext(os.path.basename(p))[0]
                out[p] = os.path.join(self.dir_pseudo, f"{stem}.json")
        return out


def combined_retrieval(
    cat_to_text_embedding: Dict[str, np.ndarray],
    bank_fps: Sequence[str],
    path_resolvers: Sequence,
    n_images: int = 500,
    cache_fp: Optional[str] = None,
    mesh=None,
    device="cuda",
) -> Dict[str, List[str]]:
    """Multi-archive retrieval: concatenate the banks (ImageNet + PASS, the
    reference's index_dataset.py:138-158) and take the global top-k per
    category in one product; `path_resolvers[i](filename)` maps bank i's
    filenames to image paths. With a mesh, the rows shard over its data
    axis and the top-k merges the gathered candidates
    (retrieval/bank.py::topk_sharded)."""
    if cache_fp and os.path.exists(cache_fp):
        with open(cache_fp) as f:
            return json.load(f)
    banks, resolved = [], []
    for fp, resolver in zip(bank_fps, path_resolvers):
        bank, filenames = load_bank_pkl([fp])
        banks.append(bank)
        resolved.extend(resolver(fn) for fn in filenames)
    bank = np.concatenate(banks, axis=0)
    wanted = {c: e for c, e in cat_to_text_embedding.items()
              if c != "background"}
    by_name = retrieve_category_paths(
        wanted, bank, resolved, n_images, mesh=mesh, device=device)
    if cache_fp:
        with open(cache_fp, "w") as f:
            json.dump(by_name, f)
    return by_name
