"""The port's instance decode and RLE codec against the JAX package:
classify_proposals and predict_semantic (f32 at rtol/atol 1e-6, summation
order), mask_nms for all three NMS types on hand-made overlapping proposals
(`keep` equal, scores at 1e-6), its selection rounds' plain version fed
with JAX's own IoU (the same tolerance, sets whose candidates run out
before round Q and a NaN score), and the RLE codec (strings equal)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zutis_tpu.ops import rle as jrle
from zutis_tpu.ops.nms import mask_nms as jmask_nms
from zutis_tpu.postproc.instance import classify_proposals as jclassify
from zutis_tpu.postproc.instance import predict_semantic as jpredict_semantic
from zutis_tpu_torch.ops import rle as trle
from zutis_tpu_torch.ops.nms import mask_nms, nms_rounds_reference, pairwise_iou
from zutis_tpu_torch.postproc.instance import classify_proposals, predict_semantic

TOL = dict(rtol=1e-6, atol=1e-6)


def _boxes(seed, b, q, h, w):
    """Overlapping rectangles: many pairs above and below the IoU threshold."""
    rng = np.random.RandomState(seed)
    masks = np.zeros((b, q, h, w), bool)
    for bi in range(b):
        for i in range(q):
            y, x = rng.randint(0, h - 6), rng.randint(0, w - 6)
            sy, sx = rng.randint(3, 9), rng.randint(3, 9)
            masks[bi, i, y:y + sy, x:x + sx] = True
    masks[:, -1] = False  # an empty mask is never kept
    return masks


def test_classify_proposals_matches_jax():
    rng = np.random.RandomState(0)
    b, q, h, w, c, n = 2, 7, 6, 5, 8, 11
    proposals = rng.rand(b, q, h, w).astype(np.float32)
    binary = proposals > 0.6
    binary[0, 3] = False  # an empty proposal
    tokens = rng.randn(b, h, w, c).astype(np.float32)
    text = rng.randn(n, c).astype(np.float32)
    conf, cats = classify_proposals(*map(torch.from_numpy,
                                         (proposals, binary, tokens, text)), 5.0)
    jconf, jcats = jclassify(*map(jnp.asarray, (proposals, binary, tokens,
                                                text)), 5.0)
    np.testing.assert_array_equal(cats.numpy(), np.asarray(jcats))
    np.testing.assert_allclose(conf.numpy(), np.asarray(jconf), **TOL)


def test_predict_semantic_matches_jax():
    rng = np.random.RandomState(1)
    tokens = rng.randn(2, 4, 6, 8).astype(np.float32)
    text = rng.randn(5, 8).astype(np.float32)
    got = predict_semantic(torch.from_numpy(tokens), torch.from_numpy(text))
    want = jpredict_semantic(jnp.asarray(tokens), jnp.asarray(text))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nms_type", ["hard", "linear", "gaussian"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_nms_matches_jax(nms_type, seed):
    b, q, h, w = 3, 20, 16, 16
    masks = _boxes(seed, b, q, h, w)
    rng = np.random.RandomState(100 + seed)
    scores = rng.rand(b, q).astype(np.float32)
    scores[:, 5] = 0.0005  # below the floor from the start: still selectable
    cats = rng.randint(0, 3, (b, q))
    keep, out = mask_nms(*map(torch.from_numpy, (masks, scores, cats)),
                         nms_type=nms_type)
    jkeep, jout = jax.vmap(lambda m, s, c: jmask_nms(m, s, c, nms_type=nms_type))(
        *map(jnp.asarray, (masks, scores, cats)))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **TOL)
    assert keep.any() and not keep[:, -1].any()


def _jax_iou(masks):
    """zutis_tpu/ops/nms.py's IoU, batched: int8 intersections in int32."""
    m8 = jnp.asarray(masks).astype(jnp.int8)
    inter = jnp.einsum("bqhw,bphw->bqp", m8, m8,
                       preferred_element_type=jnp.int32).astype(jnp.float32)
    areas = jnp.diagonal(inter, axis1=1, axis2=2)
    union = areas[:, :, None] + areas[:, None, :] - inter
    iou = jnp.where(union > 0, inter / jnp.maximum(union, 1e-12), 0.0)
    return np.array(iou), np.array(areas)


@pytest.mark.parametrize("nms_type", ["hard", "linear", "gaussian"])
@pytest.mark.parametrize("seed", [0, 1, 2, "nan"])
def test_nms_rounds_reference_on_jax_iou_matches_jax(nms_type, seed):
    """The plain rounds (the kernel's yardstick on the card) against the
    JAX fori_loop: with category 0 and empty masks, each image runs out of
    candidates before round Q; a live NaN score wins every round and is
    never selected, so its image keeps nothing."""
    b, q, h, w = 4, 24, 16, 16
    masks = _boxes(0 if seed == "nan" else seed, b, q, h, w)
    masks[:, ::5] = False
    rng = np.random.RandomState(200 + (7 if seed == "nan" else seed))
    scores = rng.rand(b, q).astype(np.float32)
    scores[:, 3] = 0.0005  # below the floor from the start: still selectable
    cats = rng.randint(0, 4, (b, q))
    if seed == "nan":
        scores[0, 6], cats[0, 6] = np.nan, 2  # live
        scores[1, 7], cats[1, 7] = np.nan, 0  # never live
    iou, areas = _jax_iou(masks)
    keep, out = nms_rounds_reference(
        *map(torch.from_numpy, (iou, areas, scores, cats)), nms_type=nms_type)
    jkeep, jout = jax.vmap(lambda m, s, c: jmask_nms(m, s, c, nms_type=nms_type))(
        *map(jnp.asarray, (masks, scores, cats)))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), equal_nan=True,
                               **TOL)
    eligible = (cats != 0) & (areas > 0)
    assert (keep.numpy().sum(1) < q).all() and (eligible.sum(1) < q).all()
    assert not keep.numpy()[~eligible].any()
    if seed == "nan":
        assert not keep[0].any() and keep[1].any()
    else:
        assert keep.any()


def test_pairwise_iou_counts_are_exact_past_tf32_range():
    """Two 48x48 masks differing in one pixel: intersections above 1024 must
    not round (TF32's 10-bit mantissa would)."""
    masks = torch.ones(1, 2, 48, 48, dtype=torch.bool)
    masks[0, 1, 0, 0] = False
    iou, areas = pairwise_iou(masks)
    assert areas.tolist() == [[2304.0, 2303.0]]
    assert iou[0, 0, 1].item() == np.float32(2303) / np.float32(2304)


def test_rle_codec_matches_jax():
    rng = np.random.RandomState(3)
    for h, w in [(48, 48), (7, 13), (1, 1)]:
        for p in (0.0, 0.3, 0.9, 1.0):
            m = (rng.rand(h, w) < p).astype(np.uint8)
            got = trle.encode(m)
            assert got == jrle.encode(m)
            np.testing.assert_array_equal(trle.decode(got), m)
            uncompressed = {"size": [h, w],
                            "counts": trle._counts_from_mask(m).tolist()}
            np.testing.assert_array_equal(trle.decode(uncompressed), m)
