"""The port's retrieval (retrieval/bank.py, data/imagenet_index.py) against
the JAX package's on the CPU:

  * load_bank_pkl: the same matrix and filenames;
  * topk_local: the indices of `jax.lax.top_k` (equal scores lowest index
    first, at the k-th boundary too) on banks with duplicate rows, values
    within 1e-5; past the bank's rows, -1 and -inf where the JAX
    single-device path refuses;
  * retrieve_category_paths, combined_retrieval, PASS.retrieve_images and
    ImageNet1KDataset's retrieval: the JAX package's lists and cache JSON,
    byte for byte, duplicates included (mirroring tests/test_imagenet_pass.py);
  * in one process, a mesh over more than one rank raises, naming the
    world size.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from test_torch_index_dataset import _assert_samples_equal
from zutis_tpu.data import imagenet_index as jax_imagenet
from zutis_tpu.ops import rle as jax_rle
from zutis_tpu.retrieval import bank as jax_bank
from zutis_tpu_torch.data import imagenet_index
from zutis_tpu_torch.retrieval import bank

CATS = ["background", "cat", "dog"]


def _unit(rng, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


def _bank_with_duplicates(seed=0, n=203, d=16, c=5):
    """Random unit rows, a third of them copies of earlier rows (a run of
    copies, and single copies spread through the bank)."""
    rng = np.random.default_rng(seed)
    bank_ = _unit(rng, n, d)
    src = rng.integers(0, n // 3, n // 3)
    dst = rng.choice(np.arange(n // 3, n), n // 3, replace=False)
    bank_[dst] = bank_[src]
    bank_[-12:] = bank_[7]  # a run of twelve copies of row 7
    text = _unit(rng, c, d)
    text[0] = bank_[7]  # row 7's copies lead category 0
    return text, bank_


def _jax_topk(text, bank_, k):
    vals, idx = jax.jit(jax_bank.topk_local, static_argnums=2)(
        jnp.asarray(text), jnp.asarray(bank_), k)
    return np.asarray(vals), np.asarray(idx)


@pytest.mark.parametrize("k", [1, 5, 13, 40, 203])
@pytest.mark.parametrize("seed", [0, 1])
def test_topk_local_equals_jax_with_duplicates(k, seed):
    text, bank_ = _bank_with_duplicates(seed)
    want_vals, want_idx = _jax_topk(text, bank_, k)
    vals, idx = bank.topk_local(torch.from_numpy(text),
                                torch.from_numpy(bank_), k)
    assert idx.dtype == torch.int64 and vals.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    np.testing.assert_allclose(vals.numpy(), want_vals, rtol=1e-5, atol=1e-6)


def test_topk_local_cuts_a_run_of_ties_at_the_lowest_indices():
    """torch.topk keeps arbitrary members of a tie at the k-th value; the
    port keeps the lowest indices, in order, as jax.lax.top_k does."""
    text = np.ones((2, 4), np.float32) / 2
    bank_ = np.tile(text[:1], (1000, 1))
    bank_[[3, 500, 999]] *= 2  # three rows score higher
    for k in (2, 3, 4, 10, 600):
        _, want = _jax_topk(text, bank_, k)
        _, got = bank.topk_local(torch.from_numpy(text),
                                 torch.from_numpy(bank_), k)
        np.testing.assert_array_equal(got.numpy(), want)
    assert list(got[0, :6]) == [3, 500, 999, 0, 1, 2]


def test_topk_local_past_the_rows_gives_minus_one():
    text, bank_ = _bank_with_duplicates(2, n=9)
    want_vals, want_idx = _jax_topk(text, bank_, 9)
    with pytest.raises(ValueError):  # the JAX single-device path refuses
        _jax_topk(text, bank_, 12)
    vals, idx = bank.topk_local(torch.from_numpy(text),
                                torch.from_numpy(bank_), 12)
    np.testing.assert_array_equal(idx[:, :9].numpy(), want_idx)
    assert (idx[:, 9:] == -1).all() and torch.isinf(vals[:, 9:]).all()
    assert (vals[:, 9:] < 0).all()
    empty = bank.topk_local(torch.from_numpy(text), torch.zeros(0, 16), 3)
    assert (empty[1] == -1).all()


def test_load_bank_pkl_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    fps = []
    for i, n in enumerate((4, 3)):
        d = {f"b{i}_{j}.jpg": _unit(rng, 8) for j in range(n)}
        fps.append(str(tmp_path / f"b{i}.pkl"))
        with open(fps[-1], "wb") as f:
            pickle.dump(d, f)
    got, want = bank.load_bank_pkl(fps), jax_bank.load_bank_pkl(fps)
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.float32


def test_retrieve_category_paths_equals_jax(tmp_path):
    text, bank_ = _bank_with_duplicates(4)
    names = [f"im{i}.JPEG" for i in range(len(bank_))]
    cat_to_text = {f"c{i}": t for i, t in enumerate(text)}
    fps = [str(tmp_path / "jax.json"), str(tmp_path / "port.json")]
    want = jax_bank.retrieve_category_paths(cat_to_text, bank_, names, 17,
                                            cache_fp=fps[0])
    got = bank.retrieve_category_paths(cat_to_text, bank_, names, 17,
                                       cache_fp=fps[1], device="cpu")
    assert got == want
    with open(fps[0], "rb") as f0, open(fps[1], "rb") as f1:
        assert f0.read() == f1.read()
    # k past the rows: every row, in the JAX order of k = N
    all_rows = jax_bank.retrieve_category_paths(cat_to_text, bank_, names,
                                                len(bank_))
    assert bank.retrieve_category_paths(cat_to_text, bank_, names, 500,
                                        device="cpu") == all_rows


@pytest.mark.parametrize("mesh", [{"data": 2}, {"data": 1, "model": 4}])
def test_a_mesh_over_devices_raises(mesh):
    # one process: a mesh of more ranks than the world refuses, naming the
    # world size (tests/test_torch_parallel_sp.py runs the sharded top-k)
    text, bank_ = _bank_with_duplicates(5, n=20)
    n = mesh.get("data", 1) * mesh.get("model", 1)
    with pytest.raises(ValueError,
                       match=f"a mesh of {n} ranks, but the world size is 1"):
        bank.retrieve_category_paths({"c": text[0]}, bank_, list("x" * 20),
                                     3, mesh=mesh, device="cpu")
    one = bank.retrieve_category_paths({"c": text[0]}, bank_,
                                       [str(i) for i in range(20)], 3,
                                       mesh={"data": 1}, device="cpu")
    assert len(one["c"]) == 3


# ---------------------------------------------------- ImageNet and PASS

@pytest.fixture(scope="module")
def imagenet_dir(tmp_path_factory):
    """tests/test_imagenet_pass.py's ImageNet layout, with a duplicate
    image in each class (equal bank rows)."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.default_rng(0)
    text = {c: _unit(rng, 8) for c in CATS[1:]}
    bank_ = {}
    for wnid, cat in (("n01", "cat"), ("n02", "dog")):
        (root / "train" / wnid).mkdir(parents=True)
        (root / "train_pseudo_masks_selfmask" / wnid).mkdir(parents=True)
        for i in range(4):
            fname = f"{wnid}_{i}.JPEG"
            Image.fromarray(rng.integers(0, 255, (40, 48, 3), np.uint8)).save(
                root / "train" / wnid / fname)
            m = np.zeros((40, 48), np.uint8)
            m[8:30, 10:40] = 1
            with open(root / "train_pseudo_masks_selfmask" / wnid /
                      f"{wnid}_{i}.json", "w") as f:
                json.dump(jax_rle.encode(m), f)
            e = text[cat] + 0.3 * rng.standard_normal(8).astype(np.float32)
            bank_[fname] = (e / np.linalg.norm(e)).astype(np.float32)
        bank_[f"{wnid}_3.JPEG"] = bank_[f"{wnid}_1.JPEG"]
    with open(root / "filename_to_ViT_L_14_336px_train_img_embedding.pkl",
              "wb") as f:
        pickle.dump(bank_, f)
    return str(root), {"background": _unit(rng, 8), **text}


@pytest.mark.parametrize("advanced", [False, True])
def test_imagenet_retrieval_equals_jax(imagenet_dir, tmp_path, advanced):
    root, text = imagenet_dir
    caches = [str(tmp_path / "jax.json"), str(tmp_path / "port.json")]
    kw = dict(categories=CATS, cat_to_text_embedding=text, n_images=3,
              image_size=64, use_advanced_copy_paste=advanced,
              min_distance=12, seed=3)
    theirs = jax_imagenet.ImageNet1KDataset(
        root, category_to_p_images_fp=caches[0], **kw)
    ours = imagenet_index.ImageNet1KDataset(
        root, category_to_p_images_fp=caches[1], device="cpu", **kw)
    with open(caches[0], "rb") as f0, open(caches[1], "rb") as f1:
        assert f0.read() == f1.read()
    with open(caches[1]) as f:
        assert list(json.load(f)) == ["cat", "dog"]
    assert ours.p_image_to_p_pseudo_mask == theirs.p_image_to_p_pseudo_mask
    assert not ours.missing_pseudo_masks()
    for index, epoch in ((0, 0), (5, 2)):
        _assert_samples_equal(ours.sample(index, epoch),
                              theirs.sample(index, epoch))
    # the cache is read back, with or without text embeddings
    again = imagenet_index.ImageNet1KDataset(
        root, CATS, category_to_p_images_fp=caches[1], image_size=64)
    assert again.p_image_to_p_pseudo_mask == ours.p_image_to_p_pseudo_mask


def test_imagenet_retrieval_without_a_cache_file(imagenet_dir):
    root, text = imagenet_dir
    kw = dict(cat_to_text_embedding=text, n_images=2, image_size=64)
    ours = imagenet_index.ImageNet1KDataset(root, CATS, device="cpu", **kw)
    theirs = jax_imagenet.ImageNet1KDataset(root, CATS, **kw)
    assert ours.p_image_to_p_pseudo_mask == theirs.p_image_to_p_pseudo_mask


def _pass_dir(root, rng, n=6):
    (root / "images" / "0").mkdir(parents=True)
    (root / "images" / "1").mkdir(parents=True)
    bank_ = {}
    for i in range(n):
        rel = f"{i % 2}/img{i}.jpg"
        Image.fromarray(rng.integers(0, 255, (16, 16, 3), np.uint8)).save(
            root / "images" / rel)
        bank_[rel] = _unit(rng, 8)
    bank_["1/img5.jpg"] = bank_["0/img0.jpg"]  # a duplicate
    with open(root / "filename_to_ViT_L_14_336px_img_embedding.pkl",
              "wb") as f:
        pickle.dump(bank_, f)
    return str(root)


def test_pass_retrieval_equals_jax(tmp_path):
    rng = np.random.default_rng(2)
    root = _pass_dir(tmp_path / "pass", rng)
    text = {"background": _unit(rng, 8), "cat": _unit(rng, 8),
            "dog": _unit(rng, 8)}
    caches = [str(tmp_path / "jax.json"), str(tmp_path / "port.json")]
    want = jax_imagenet.PASS(root).retrieve_images(text, 4, cache_fp=caches[0])
    ours = imagenet_index.PASS(root)
    assert ours.image_paths() == jax_imagenet.PASS(root).image_paths()
    got = ours.retrieve_images(text, 4, cache_fp=caches[1], device="cpu")
    assert got == want and list(got) == ["cat", "dog"]
    with open(caches[0], "rb") as f0, open(caches[1], "rb") as f1:
        assert f0.read() == f1.read()
    assert ours.retrieve_images({}, 4, cache_fp=caches[1]) == want  # cached
    assert ours.pseudo_mask_paths(got) == \
        jax_imagenet.PASS(root).pseudo_mask_paths(want)


def test_combined_retrieval_equals_jax(tmp_path, imagenet_dir):
    root, text = imagenet_dir
    pass_root = _pass_dir(tmp_path / "pass", np.random.default_rng(8))
    fps = [f"{root}/filename_to_ViT_L_14_336px_train_img_embedding.pkl",
           imagenet_index.PASS(pass_root).bank_fp]
    resolvers = [lambda fn: imagenet_index.imagenet_filename_to_path(root, fn),
                 lambda fn: os.path.join(pass_root, "images", fn)]
    caches = [str(tmp_path / "jax.json"), str(tmp_path / "port.json")]
    for n_images in (3, 9):
        want = jax_imagenet.combined_retrieval(text, fps, resolvers, n_images,
                                               cache_fp=caches[0])
        got = imagenet_index.combined_retrieval(
            text, fps, resolvers, n_images, cache_fp=caches[1], device="cpu")
        assert got == want
        with open(caches[0], "rb") as f0, open(caches[1], "rb") as f1:
            assert f0.read() == f1.read()
        assert imagenet_index.combined_retrieval(
            {}, fps, resolvers, cache_fp=caches[1]) == want  # cached
        os.remove(caches[0])
        os.remove(caches[1])
    assert any("/images/" in p for p in got["cat"] + got["dog"])
    assert any("/train/" in p for p in got["cat"] + got["dog"])
