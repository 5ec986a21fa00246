"""The port's evaluation datasets (data/datasets.py) against the JAX
package's on on-disk fixtures: COCO2017 (semantic mask from the PNG, and
rendered from polygon and RLE annotations largest first), COCO-20K (with
its `_build_sel20k`), CoCA and ImageNet-S (the longer edge capped at 1024
by the bilinear resampler; GT as R + 256 G). Every item's every key is
equal, images bit for bit."""
import json
import shutil

import numpy as np
import pytest
from PIL import Image

from zutis_tpu.data import datasets as jax_ds
from zutis_tpu.ops import rle as jax_rle
from zutis_tpu_torch.data import datasets as ds


def _picture(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 70 * np.cos(xx / (5 + c) - yy / (7 + c))
                    for c in range(3)], -1) + rng.normal(0, 9, (h, w, 3))
    return Image.fromarray(np.clip(img, 0, 255).astype(np.uint8))


def _coco_annotations(rng, images):
    anns = []
    for info in images:
        h, w = info["height"], info["width"]
        for k in range(3):
            x0, y0 = rng.uniform(0, w / 2), rng.uniform(0, h / 2)
            x1, y1 = x0 + rng.uniform(4, w / 2), y0 + rng.uniform(4, h / 2)
            if k == 2:  # an RLE annotation beside the polygons
                m = np.zeros((h, w), np.uint8)
                m[int(y0):int(y1), int(x0):int(x1)] = 1
                seg = jax_rle.encode(m)
            else:
                seg = [[x0, y0, x1, y0 + 2, x1 - 3, y1, x0 + 1, y1 - 1]]
            anns.append({"id": len(anns) + 1, "image_id": info["id"],
                         "category_id": int(rng.choice([1, 3, 18, 90])),
                         "segmentation": seg, "iscrowd": 0,
                         "area": float((x1 - x0) * (y1 - y0))})
    return anns


def _assert_items_equal(got, want):
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        if isinstance(w, np.ndarray) or isinstance(g, np.ndarray):
            assert g.dtype == w.dtype, key
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif w is None:
            assert g is None, key
        else:
            assert g == w, key


def _assert_datasets_equal(ours, theirs):
    assert len(ours) == len(theirs) > 0
    assert (ours.name, ours.n_categories, ours.ignore_index) == (
        theirs.name, theirs.n_categories, theirs.ignore_index)
    for i in range(len(theirs)):
        _assert_items_equal(ours[i], theirs[i])


@pytest.fixture(scope="module")
def coco2017(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco2017")
    (root / "val2017").mkdir()
    (root / "annotations" / "semantic_segmentation_masks").mkdir(parents=True)
    rng = np.random.default_rng(0)
    images = []
    for i, (h, w, sub) in enumerate([(48, 64, 2), (37, 53, 1), (60, 41, 0),
                                     (23, 29, 2)]):
        name = f"{i + 1:012d}.jpg"
        _picture(rng, h, w).save(root / "val2017" / name, quality=85,
                                 subsampling=sub)
        images.append({"id": i + 1, "height": h, "width": w,
                       "file_name": name})
    # one image has its semantic mask rendered to a PNG
    sem = rng.integers(0, 81, (48, 64), dtype=np.uint8)
    Image.fromarray(sem).save(
        root / "annotations" / "semantic_segmentation_masks"
        / "000000000001.png")
    with open(root / "annotations" / "instances_val2017.json", "w") as f:
        json.dump({"images": images,
                   "annotations": _coco_annotations(rng, images),
                   "categories": [{"id": c} for c in (1, 3, 18, 90)]}, f)
    return root


def test_coco2017_equals_jax(coco2017):
    ours = ds.get_eval_dataset("coco2017", str(coco2017))
    _assert_datasets_equal(ours, jax_ds.COCO2017Dataset(str(coco2017)))
    assert ours.p_annotations.endswith("instances_val2017.json")


def test_coco20k_equals_jax_and_builds_the_same_selection(tmp_path):
    rng = np.random.default_rng(1)
    src = tmp_path / "src"
    (src / "images").mkdir(parents=True)
    (src / "annotations").mkdir()
    images = []
    for i in range(5):
        name = f"COCO_train2014_{i + 7:012d}.jpg"
        h, w = (int(v) for v in rng.integers(20, 60, 2))
        _picture(rng, h, w).save(src / "images" / name, quality=80)
        images.append({"id": i + 7, "height": h, "width": w,
                       "file_name": name})
    with open(src / "annotations" / "instances_train2014.json", "w") as f:
        json.dump({"images": images,
                   "annotations": _coco_annotations(rng, images),
                   "categories": [{"id": 1}]}, f)
    with open(src / "coco_20k_filenames.txt", "w") as f:
        f.write("\n".join(["train2014/COCO_train2014_000000000007.jpg",
                           "train2014/COCO_train2014_000000000009.jpg",
                           "train2014/COCO_train2014_000000000011.jpg", ""]))
    mine, theirs_dir = tmp_path / "port", tmp_path / "jax"
    shutil.copytree(src, mine)
    shutil.copytree(src, theirs_dir)
    ours = ds.get_eval_dataset("coco20k", str(mine))
    theirs = jax_ds.COCO20KDataset(str(theirs_dir))
    sel = "annotations/instances_train2014_sel20k.json"
    assert json.loads((mine / sel).read_text()) == json.loads(
        (theirs_dir / sel).read_text())
    assert ours.image_ids == theirs.image_ids == [7, 9, 11]
    for i in range(len(theirs)):
        got, want = ours[i], theirs[i]
        assert got["p_image"].replace(str(mine), "") == \
            want["p_image"].replace(str(theirs_dir), "")
        np.testing.assert_array_equal(got["image"], want["image"])
        assert got["image_size"] == want["image_size"]
        assert got["image_id"] == want["image_id"]


def test_coca_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    for cat in ("Accordion", "Banana", "Zebra"):
        (tmp_path / "image" / cat).mkdir(parents=True)
        (tmp_path / "binary" / cat).mkdir(parents=True)
        for i in range(2):
            h, w = (int(v) for v in rng.integers(20, 50, 2))
            _picture(rng, h, w).save(tmp_path / "image" / cat / f"{i}.jpg",
                                     quality=90, subsampling=i)
            gt = (rng.random((h, w)) > 0.6).astype(np.uint8) * 255
            Image.fromarray(gt).save(tmp_path / "binary" / cat / f"{i}.png")
    _assert_datasets_equal(ds.get_eval_dataset("coca", str(tmp_path)),
                           jax_ds.COCADataset(str(tmp_path)))


@pytest.mark.parametrize("split", ["val", "train", "test"])
def test_imagenet_s_equals_jax(tmp_path, split):
    rng = np.random.default_rng(3)
    folder = {"val": "validation", "train": "train", "test": "test"}[split]
    gt_folder = {"val": "validation-segmentation",
                 "train": "train-semi-segmentation"}.get(split)
    base = tmp_path / "ImageNetS50"
    sizes = [(40, 60), (300, 1100), (1030, 200), (33, 47)]  # two capped
    for i, (h, w) in enumerate(sizes):
        wnid = f"n0{i % 2}"
        (base / folder / wnid).mkdir(parents=True, exist_ok=True)
        _picture(rng, h, w).save(base / folder / wnid / f"{wnid}_{i}.JPEG",
                                 quality=70)
        if gt_folder:
            (base / gt_folder / wnid).mkdir(parents=True, exist_ok=True)
            gt = np.zeros((h, w, 3), np.uint8)
            gt[..., 0] = rng.integers(0, 256, (h, w))
            gt[..., 1] = rng.integers(0, 4, (h, w))
            Image.fromarray(gt).save(base / gt_folder / wnid / f"{wnid}_{i}.png")
    ours = ds.get_eval_dataset("imagenet-s", str(tmp_path), split=split,
                               n_categories=51)
    theirs = jax_ds.ImageNetSDataset(str(tmp_path), 50, split=split)
    _assert_datasets_equal(ours, theirs)
    assert max(ours[1]["image"].shape[-2:]) == 1024


def test_unknown_dataset_raises():
    with pytest.raises(ValueError, match="unknown dataset"):
        ds.get_eval_dataset("voc2012", "/nowhere")
