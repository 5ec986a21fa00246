"""The port's COCO layer against the JAX package: the RLE host helpers
(zutis_tpu_torch.ops.rle), COCOEvaluator and COCOIndex, and the functions
of postproc/instance.py that make the COCO prediction list, with
pack_masks_fortran.

Strings, boxes and masks must be equal; stats equal to 1e-12 (the same
float64 arithmetic in the same order). Polygons are held against OpenCV's
fillPoly, which the JAX package calls, for vertices inside the image and
outside it."""
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from zutis_tpu.data.coco_api import COCOIndex as JCOCOIndex
from zutis_tpu.engine.coco_eval import COCOEvaluator as JCOCOEvaluator
from zutis_tpu.ops import rle as jrle
from zutis_tpu.ops.rle_device import rle_encode_masks_device as jencode
from zutis_tpu.postproc import instance as jinst
from zutis_tpu_torch.data.coco_api import COCOIndex
from zutis_tpu_torch.engine.batched_eval import SideStreamView
from zutis_tpu_torch.engine.coco_eval import COCOEvaluator
from zutis_tpu_torch.ops import rle
from zutis_tpu_torch.ops.rle_device import rle_encode_masks_device
from zutis_tpu_torch.postproc import instance

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def _load(name):
    with open(os.path.join(FIXTURES, name)) as f:
        return json.load(f)


def test_codec_matches_the_golden_vectors():
    fix = _load("rle_golden.json")
    for case in fix["counts_to_string"]:
        assert rle._compress_counts(case["counts"]) == case["string"]
        assert rle.counts_of({"counts": case["string"]}).tolist() == case["counts"]
    for case in fix["mask_to_counts"]:
        m = np.array([[int(c) for c in r] for r in case["mask_rows"]], np.uint8)
        assert rle.encode(m)["counts"] == case["string"]


@pytest.mark.parametrize("scenario", _load("coco_eval_golden.json")["scenarios"],
                         ids=lambda s: s["name"])
def test_evaluator_matches_the_golden_scenarios(scenario):
    got = COCOEvaluator(scenario["gt"]).evaluate(scenario["predictions"])
    want = JCOCOEvaluator(scenario["gt"]).evaluate(scenario["predictions"])
    assert got == want
    for key, value in scenario["expected"].items():
        assert got[key] == pytest.approx(value, abs=1e-9)


def _random_coco(seed, n_images=4, h=80, w=72):
    """Random rectangle-and-noise masks: GT with crowd and ignore flags over
    three categories, predictions that overlap them partly."""
    rng = np.random.RandomState(seed)
    images, anns, preds = [], [], []
    for img_id in range(1, n_images + 1):
        images.append({"id": img_id, "height": h, "width": w})
        for _ in range(rng.randint(1, 5)):
            m = np.zeros((h, w), np.uint8)
            y, x = rng.randint(0, h - 4), rng.randint(0, w - 4)
            m[y:y + rng.randint(2, 45), x:x + rng.randint(2, 45)] = 1
            m ^= (rng.rand(h, w) < 0.002).astype(np.uint8)
            cat = int(rng.randint(1, 4))
            ann = {"id": len(anns) + 1, "image_id": img_id,
                   "category_id": cat, "segmentation": rle.encode(m),
                   "area": int(m.sum()), "iscrowd": int(rng.rand() < 0.15)}
            if rng.rand() < 0.1:
                ann["ignore"] = 1
            anns.append(ann)
            for _ in range(rng.randint(0, 3)):
                d = np.roll(m, (rng.randint(-2, 3), rng.randint(-2, 3)), (0, 1))
                preds.append({"image_id": img_id,
                              "category_id": cat if rng.rand() < 0.8 else 3,
                              "segmentation": rle.encode(d),
                              "score": float(rng.rand())})
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": c} for c in (1, 2, 3)]}
    return gt, preds


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_evaluator_matches_jax_on_random_cases(seed):
    gt, preds = _random_coco(seed)
    got = COCOEvaluator(gt, max_dets=(1, 3, 100)).evaluate(preds)
    want = JCOCOEvaluator(gt, max_dets=(1, 3, 100)).evaluate(preds)
    assert got == pytest.approx(want, abs=1e-12)
    assert any(0 < v < 1 for v in got.values())


def test_counts_iou_equals_mask_iou_and_jax():
    rng = np.random.RandomState(5)
    dts = (rng.rand(4, 12, 9) < 0.4).astype(np.uint8)
    gts = (rng.rand(3, 12, 9) < 0.4).astype(np.uint8)
    gts[2] = 0
    crowd = [False, True, False]
    counts = [[rle._counts_from_mask(m) for m in ms] for ms in (dts, gts)]
    got = rle.counts_iou(*counts, iscrowd=crowd)
    np.testing.assert_array_equal(got, rle.mask_iou(dts, gts, crowd))
    np.testing.assert_array_equal(got, jrle.counts_iou(*counts, iscrowd=crowd))
    np.testing.assert_array_equal(rle.mask_iou(dts, gts, crowd),
                                  jrle.mask_iou(dts, gts, crowd))


def test_area_and_bbox_match_jax():
    rng = np.random.RandomState(6)
    for p in (0.0, 0.1, 0.9):
        m = (rng.rand(11, 7) < p).astype(np.uint8)
        enc = rle.encode(m)
        assert rle.area(enc) == jrle.area(enc) == int(m.sum())
        assert rle.to_bbox(m) == jrle.to_bbox(m)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_polygons_match_opencv_inside_the_image(seed):
    rng = np.random.RandomState(seed)
    for _ in range(200):
        h, w = rng.randint(2, 48, 2)
        polys = [np.stack([rng.uniform(0, w - 0.51, n), rng.uniform(0, h - 0.51, n)],
                          1).reshape(-1).tolist()
                 for n in rng.randint(3, 9, rng.randint(1, 4))]
        np.testing.assert_array_equal(rle.polygons_to_mask(polys, h, w),
                                      jrle.polygons_to_mask(polys, h, w))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_polygons_match_opencv_across_the_border(seed):
    """Vertices up to 8 px outside the image, a third of them rounding to
    exactly w or h (where a COCO polygon meets the border): the sides that
    OpenCV clips fill the border row or column as it does."""
    rng = np.random.RandomState(seed)
    for _ in range(250):
        h, w = rng.randint(1, 48, 2)
        polys = []
        for n in rng.randint(3, 9, rng.randint(1, 4)):
            xs, ys = rng.uniform(-8, w + 8, n), rng.uniform(-8, h + 8, n)
            at_w, at_h = rng.rand(n) < 1 / 3, rng.rand(n) < 1 / 3
            xs[at_w] = w + rng.uniform(-0.49, 0.49, at_w.sum())
            ys[at_h] = h + rng.uniform(-0.49, 0.49, at_h.sum())
            polys.append(np.stack([xs, ys], 1).reshape(-1).tolist())
        np.testing.assert_array_equal(rle.polygons_to_mask(polys, h, w),
                                      jrle.polygons_to_mask(polys, h, w))


def test_coco_index_matches_jax():
    gt, _ = _random_coco(7)
    poly = [5.2, 3.0, 30.1, 4.4, 20.7, 33.9, 2.0, 20.5]
    gt["annotations"].append({"id": 99, "image_id": 2, "category_id": 1,
                              "segmentation": [poly], "area": 1.0,
                              "iscrowd": 0})
    got, want = COCOIndex(gt), JCOCOIndex(gt)
    assert got.get_img_ids() == want.get_img_ids()
    for img_id in got.get_img_ids():
        assert got.load_img(img_id) == want.load_img(img_id)
        assert got.load_anns(img_id) == want.load_anns(img_id)
        for ann in got.load_anns(img_id):
            np.testing.assert_array_equal(got.ann_to_mask(ann),
                                          want.ann_to_mask(ann))


@pytest.mark.parametrize("h,w", [(16, 5), (13, 7), (1, 1), (9, 8)])
def test_pack_masks_fortran_matches_jax(h, w):
    masks = np.random.RandomState(h * w).rand(2, 3, h, w) < 0.4
    got = instance.pack_masks_fortran(torch.from_numpy(masks))
    want = np.asarray(jinst.pack_masks_fortran(jnp.asarray(masks)))
    np.testing.assert_array_equal(got.numpy(), want)
    stride = instance.col_stride_bits(h)
    assert stride == jinst.col_stride_bits(h)
    np.testing.assert_array_equal(
        instance._unpack_mask_fortran(got[1, 2].numpy(), stride, h, w),
        masks[1, 2])


def _decoded_batch(seed, b=3, q=12, H=20, W=18):
    """A decode's outputs: boxes with overlaps, some kept, native windows."""
    rng = np.random.RandomState(seed)
    sizes = [(20, 18), (15, 11), (9, 18)]
    masks = np.zeros((b, q, H, W), bool)
    for bi, (h, w) in enumerate(sizes):
        for qi in range(q):
            y, x = rng.randint(0, h - 2), rng.randint(0, w - 2)
            masks[bi, qi, y:y + rng.randint(1, 9), x:x + rng.randint(1, 9)] = True
        masks[bi, :, h:] = False
        masks[bi, :, :, w:] = False
    masks[0, 2, ::2, :] = masks[0, 2, ::2, :] | (np.arange(W) < 18)  # many runs
    masks[0, 3] = False  # kept but empty
    keep = rng.rand(b, q) < 0.6
    keep[0, :] = True  # more kept than k_cap
    scores = rng.rand(b, q).astype(np.float32)
    cats = rng.randint(0, 4, (b, q))
    return masks, keep, scores, cats, sizes


@pytest.mark.parametrize("fallback", ["dev_masks", "dev_packed"])
def test_instances_to_coco_counts_matches_jax(fallback):
    masks, keep, scores, cats, sizes = _decoded_batch(0)
    caps = dict(k_cap=8, col_cap=4, max_runs=24)
    pix = np.asarray(sizes)
    dev = rle_encode_masks_device(torch.from_numpy(masks), torch.from_numpy(keep),
                                  torch.from_numpy(pix), **caps)
    jdev = jencode(jnp.asarray(masks), jnp.asarray(keep), jnp.asarray(pix), **caps)
    assert dev["overflow"].any() and (dev["n_kept"] > 8).any()
    res = {k: v.numpy() for k, v in dev.items()}
    res.update(scores=scores, category_ids=cats, keep=keep)
    jres = {k: np.asarray(v) for k, v in jdev.items()}
    jres.update(scores=scores, category_ids=cats, keep=keep)
    label = {i: 100 + i for i in range(4)}
    names = {100 + i: f"c{i}" for i in range(4)}
    kw = dict(image_ids=[7, 8, 9], sizes=sizes, label_id_to_category=names,
              new_label_id_to_old_label_id=label)
    if fallback == "dev_masks":
        got = instance.instances_to_coco_counts(
            res, dev_masks=SideStreamView(torch.from_numpy(masks)), **kw)
    else:
        packed = instance.pack_masks_fortran(torch.from_numpy(masks))
        got = instance.instances_to_coco_counts(
            res, dev_packed=packed, col_stride_bits_packed=24, **kw)
    want = jinst.instances_to_coco_counts(jres, dev_masks=jnp.asarray(masks), **kw)
    assert got == want
    dense = instance.instances_to_coco(
        {"masks": masks, "scores": scores, "category_ids": cats, "keep": keep},
        [7, 8, 9])
    assert len(dense) == len(got)


def test_instances_to_coco_packed_and_dense_match_jax():
    masks, keep, scores, cats, sizes = _decoded_batch(1)
    out = {"masks": masks, "scores": scores, "category_ids": cats, "keep": keep}
    got = instance.instances_to_coco(out, [1, 2, 3], new_label_id_to_old_label_id=None)
    want = jinst.instances_to_coco(out, [1, 2, 3])
    assert got == want and got
    packed = dict(out, masks_packed=instance.pack_masks_fortran(
        torch.from_numpy(masks)).numpy(), col_stride_bits=24)
    got = instance.instances_to_coco_packed(packed, [1, 2, 3], sizes)
    want = jinst.instances_to_coco_packed(packed, [1, 2, 3], sizes)
    assert got == want and got


@pytest.mark.parametrize("nms_type", ["hard", "linear", "gaussian"])
def test_predict_instances_device_matches_jax(nms_type):
    """The per-image decode with the upsample to the image size, the packed
    bits and the device RLE, against the JAX function."""
    rng = np.random.RandomState(8)
    proposals = rng.rand(2, 1, 6, 5, 4).astype(np.float32)
    tokens = rng.randn(2, 5, 4, 8).astype(np.float32)
    text = rng.randn(3, 8).astype(np.float32)
    kw = dict(size=(11, 9), threshold=0.5, nms_type=nms_type)
    got = instance.predict_instances_device(
        *map(torch.from_numpy, (proposals, tokens, text)), pack=True, rle=True,
        **kw)
    want = jinst.predict_instances_device(
        *map(jnp.asarray, (proposals, tokens, text)), pack=True, rle=True, **kw)
    assert got["keep"].any()
    for key in ("masks", "keep", "category_ids", "masks_packed"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    np.testing.assert_allclose(got["scores"].numpy(), np.asarray(want["scores"]),
                               rtol=1e-6, atol=1e-6)
    assert got["col_stride_bits"] == int(want["col_stride_bits"])
    for key, value in got["rle"].items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(want["rle"][key]),
                                      err_msg=key)
