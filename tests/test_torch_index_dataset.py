"""The port's training datasets (data/index_dataset.py, imagenet_index.py,
pseudo_masks.py) against the JAX package's on an on-disk fixture of JPEGs
(4:2:0, 4:2:2, 4:4:4, progressive, grayscale, CMYK, a PNG under a .JPEG
name as ImageNet has one) and RLE pseudo-masks: `IndexDataset.sample` in
both modes over several (seed, epoch, index) gives the same masks,
validity, categories and images (bit for bit: the decoder, resampler and
blur are exact), and `batch_iterator`'s batch t is the JAX one, resumed and
sharded over processes."""
import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from zutis_tpu.data import imagenet_index as jax_imagenet
from zutis_tpu.data import index_dataset as jax_index
from zutis_tpu.data import pseudo_masks as jax_pseudo
from zutis_tpu.ops import rle as jax_rle
from zutis_tpu_torch.data import imagenet_index, index_dataset
from zutis_tpu_torch.data.pseudo_masks import pseudo_mask_path

CATEGORIES = ["background", "dog", "kite", "mug"]
SAVE = [dict(quality=85, subsampling=2), dict(quality=90, subsampling=1),
        dict(quality=75, subsampling=0),
        dict(quality=80, subsampling=2, progressive=True)]


def _picture(rng, h, w):
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 80 * np.sin(xx / (4 + c) + yy / (6 + 2 * c) + c)
                    for c in range(3)], -1) + rng.normal(0, 10, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_image(rng, path, h, w, k):
    img = Image.fromarray(_picture(rng, h, w))
    if k == 5:
        img.convert("L").save(path, "JPEG", quality=80)
    elif k == 6:
        img.convert("CMYK").save(path, "JPEG", quality=90)
    elif k == 7:
        img.save(path, "PNG")  # ImageNet holds a PNG named .JPEG
    else:
        img.save(path, "JPEG", **SAVE[k % len(SAVE)])


@pytest.fixture(scope="module")
def archive(tmp_path_factory):
    """ImageNet-style layout: train/<wnid>/<wnid>_<i>.JPEG, the flat
    pseudo-mask directory and the ImageNet one, the category cache."""
    root = tmp_path_factory.mktemp("index")
    rng = np.random.default_rng(0)
    dir_pm = root / "cache" / "pseudo_masks"
    dir_pm.mkdir(parents=True)
    cat_to_paths, k = {}, 0
    for ci, cat in enumerate(CATEGORIES[1:]):
        wnid = f"n0000{ci}"
        (root / "train" / wnid).mkdir(parents=True)
        (root / "train_pseudo_masks_selfmask" / wnid).mkdir(parents=True)
        cat_to_paths[cat] = []
        for i in range(3):
            h, w = (int(v) for v in rng.integers(30, 90, 2))
            p = root / "train" / wnid / f"{wnid}_{i}.JPEG"
            _write_image(rng, p, h, w, k)
            k += 1
            mask = np.zeros((h, w), np.uint8)
            y0, x0 = rng.integers(0, h // 2), rng.integers(0, w // 2)
            mask[y0:y0 + rng.integers(4, h // 2 + 4),
                 x0:x0 + rng.integers(4, w // 2 + 4)] = 1
            rle = jax_rle.encode(mask)
            for pm in (pseudo_mask_path(str(dir_pm), str(p)),
                       imagenet_index.imagenet_pseudo_mask_path(str(root),
                                                                str(p))):
                with open(pm, "w") as f:
                    json.dump(rle, f)
            cat_to_paths[cat].append(str(p))
    cat_fp = root / "cache" / "category_to_p_images.json"
    with open(cat_fp, "w") as f:
        json.dump(cat_to_paths, f)
    return root, str(cat_fp), str(dir_pm)


def _pair(archive, **kw):
    root, cat_fp, dir_pm = archive
    cat_to_paths = index_dataset.load_category_to_p_images(cat_fp)
    assert cat_to_paths == jax_index.load_category_to_p_images(cat_fp)
    pm = {p: pseudo_mask_path(dir_pm, p)
          for ps in cat_to_paths.values() for p in ps}
    args = (CATEGORIES, cat_to_paths, pm)
    kw = dict(image_size=64, max_n_masks=10, **kw)
    return (index_dataset.IndexDataset(*args, **kw),
            jax_index.IndexDataset(*args, **kw))


def _assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


SAMPLES = [(0, 0, 0), (0, 0, 5), (0, 1, 5), (3, 2, 11), (7, 0, 1), (11, 5, 8)]


@pytest.mark.parametrize("seed,epoch,index", SAMPLES)
@pytest.mark.parametrize("random_duplicate", [False, True])
def test_sample_equals_jax(archive, seed, epoch, index, random_duplicate):
    ours, theirs = _pair(archive, seed=seed, scale_range=(0.1, 1.0),
                         random_duplicate=random_duplicate)
    _assert_samples_equal(ours.sample(index, epoch),
                          theirs.sample(index, epoch))


@pytest.mark.parametrize("seed,epoch,index", SAMPLES)
def test_advanced_copy_paste_sample_equals_jax(archive, seed, epoch, index):
    ours, theirs = _pair(archive, seed=seed, use_advanced_copy_paste=True,
                         min_distance=12)
    got = ours.sample(index, epoch)
    _assert_samples_equal(got, theirs.sample(index, epoch))
    assert got["instance_valid"].sum() >= 1


def test_getitem_and_len(archive):
    ours, theirs = _pair(archive, seed=4)
    assert len(ours) == len(theirs) == 9
    assert ours.p_images == theirs.p_images
    _assert_samples_equal(ours[3], theirs[3])


def _numpy(batch):
    return {k: v.numpy() for k, v in batch.items()}


def test_batch_iterator_equals_jax_with_resume_and_sharding(archive):
    ours, theirs = _pair(archive, seed=2)
    want = jax_index.batch_iterator(theirs, 4, seed=9, num_threads=1,
                                   as_jax=False)
    want = [next(want) for _ in range(4)]
    got_it = index_dataset.batch_iterator(ours, 4, seed=9, num_threads=1,
                                          device="cpu")
    got = [_numpy(next(got_it)) for _ in range(4)]
    got_it.close()
    for g, w in zip(got, want):
        assert all(isinstance(v, np.ndarray) for v in g.values())
        _assert_samples_equal(g, w)
    resumed = index_dataset.batch_iterator(ours, 4, seed=9, start_step=2,
                                           num_threads=3, device="cpu")
    for t in (2, 3):
        _assert_samples_equal(_numpy(next(resumed)), want[t])
    resumed.close()
    halves = [index_dataset.batch_iterator(ours, 4, seed=9, num_threads=1,
                                           device="cpu", process_index=i,
                                           process_count=2)
              for i in range(2)]
    for t in range(2):
        parts = [_numpy(next(h)) for h in halves]
        joined = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
        _assert_samples_equal(joined, want[t])
    for h in halves:
        h.close()


def test_batch_iterator_yields_torch_tensors(archive):
    ours, _ = _pair(archive, seed=2)
    it = index_dataset.batch_iterator(ours, 2, num_threads=1, device="cpu")
    batch = next(it)
    it.close()
    assert {k: v.dtype for k, v in batch.items()} == {
        "image": torch.float32, "semantic_mask": torch.int32,
        "instance_masks": torch.float32, "instance_valid": torch.bool,
        "category_ids": torch.int32}
    assert batch["image"].shape == (2, 3, 64, 64)


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal")
def test_batch_iterator_for_a_card_raises_without_one(archive):
    ours, _ = _pair(archive)
    with pytest.raises(RuntimeError, match="cuda"):
        next(index_dataset.batch_iterator(ours, 2, device="cuda"))


class _Failing:
    def __len__(self):
        return 5

    def sample(self, index, epoch=0):
        if epoch == 1:
            raise KeyError(f"broken sample {index}")
        return {"x": np.zeros(2, np.float32)}


def test_batch_iterator_raises_the_producers_error():
    it = index_dataset.batch_iterator(_Failing(), 2, num_threads=1,
                                      device="cpu")
    assert next(it)["x"].shape == (2, 2)
    with pytest.raises(KeyError, match="broken sample"):
        next(it)


def test_pseudo_mask_paths_equal_jax(archive):
    root = str(archive[0])
    for p in ("/d/train/n01/n01_3.JPEG", "rel/v/x.jpg", "a/b/c/d.e.png"):
        assert pseudo_mask_path("/pm", p) == jax_pseudo.pseudo_mask_path(
            "/pm", p)
        assert imagenet_index.imagenet_pseudo_mask_path(root, p) == \
            jax_imagenet.imagenet_pseudo_mask_path(root, p)
    for fn in ("n01440764_10026.JPEG", "n0_1.JPEG"):
        for split in ("train", "val"):
            assert imagenet_index.imagenet_filename_to_path(root, fn, split) \
                == jax_imagenet.imagenet_filename_to_path(root, fn, split)


@pytest.mark.parametrize("advanced", [False, True])
def test_imagenet_dataset_equals_jax(archive, advanced):
    root, cat_fp, _ = archive
    kw = dict(categories=CATEGORIES, category_to_p_images_fp=cat_fp,
              image_size=64, use_advanced_copy_paste=advanced,
              min_distance=12, seed=3)
    ours = imagenet_index.ImageNet1KDataset(str(root), **kw)
    theirs = jax_imagenet.ImageNet1KDataset(str(root), **kw)
    assert ours.missing_pseudo_masks() == theirs.missing_pseudo_masks() == []
    assert ours.p_image_to_p_pseudo_mask == theirs.p_image_to_p_pseudo_mask
    for index, epoch in ((0, 0), (4, 1), (8, 3)):
        _assert_samples_equal(ours.sample(index, epoch),
                              theirs.sample(index, epoch))


def test_imagenet_dataset_without_a_cache_raises(archive, tmp_path):
    # retrieval needs text embeddings (tests/test_torch_retrieval.py)
    with pytest.raises(ValueError, match="no text embeddings"):
        imagenet_index.ImageNet1KDataset(
            str(archive[0]), CATEGORIES,
            category_to_p_images_fp=str(tmp_path / "none.json"))


def test_a_missing_pseudo_mask_raises(archive, tmp_path):
    ours, _ = _pair(archive)
    ours.p_image_to_p_pseudo_mask = {
        p: str(tmp_path / "missing.json") for p in ours.p_images}
    with pytest.raises(FileNotFoundError):
        ours.sample(0)
    assert os.path.exists(archive[1])
