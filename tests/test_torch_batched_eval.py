"""The port's bucketed eval path (forward_padded, the instance step,
pipelined, evaluate_instances) against zutis_tpu/engine/batched_eval.py and
the batched loop of zutis_tpu/cli/coco20k_eval.py, from one flax init at the
tiny config of tests/test_batched_eval.py.

Forward outputs are held at rtol 2e-4, atol 2e-5 in f32 (summation order);
bf16 forwards at atol 2e-2 on the "torch" attention path, which is JAX's
CPU path; keep, category ids, masks, the device RLE and the COCO strings
must be equal, and scores agree at 1e-6 (the port's classification
statistics run in float64, JAX's in float32)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zutis_tpu.engine import batched_eval as JBE
from zutis_tpu.engine.coco_eval import COCOEvaluator as JCOCOEvaluator
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu.ops.rle_device import unpack_host_blob
from zutis_tpu.postproc.instance import instances_to_coco_counts as jto_coco
from zutis_tpu_torch.engine import batched_eval as BE
from zutis_tpu_torch.engine.coco_eval import COCOEvaluator
from zutis_tpu_torch.models.weights import load_params
from zutis_tpu_torch.models.zutis import ZUTIS
from zutis_tpu_torch.ops import rle

TOL = dict(rtol=2e-4, atol=2e-5)
CFG = dict(width=32, encoder_layers=2, encoder_heads=2, patch_size=16,
           text_dim=16, n_queries=8, n_decoder_layers=2, n_heads=2,
           input_resolution=32)
SIZES = [(48, 48), (32, 48), (37, 33)]  # (H, W) native pixel sizes
BUCKET = (48, 48)
THRESHOLD = 0.4


@pytest.fixture(scope="module")
def setup():
    jmodel = JZUTIS(**CFG)
    rng = np.random.RandomState(0)
    imgs = [rng.randn(3, h, w).astype(np.float32) for h, w in SIZES]
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(imgs[0][None]))["params"]
    params = jax.tree.map(np.asarray, params)
    text = rng.randn(5, 16).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    model = load_params(ZUTIS(**CFG, device="cpu"), params).eval()
    return jmodel, params, model, imgs, text


def _padded(imgs, dtype=np.float32):
    return BE.pad_batch(imgs, BUCKET, len(imgs), 16, dtype=dtype)


def _jax_step(jmodel, params, text, padded, grid, pix, **kw):
    step = JBE.make_instance_step(jmodel, jnp.asarray(text), BUCKET,
                                  threshold=THRESHOLD, **kw)
    out = step(params, *map(jnp.asarray, (padded, grid, pix)))
    return jax.tree.map(np.asarray, out)


def test_pad_batch_matches_jax(setup):
    imgs = setup[3]
    for got, want in zip(BE.pad_batch(imgs[:2], BUCKET, 3, 16),
                         JBE.pad_batch(imgs[:2], BUCKET, 3, 16)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_forward_padded_matches_flax(setup, dtype):
    jmodel, params, model, imgs, _ = setup
    padded, grid, _ = _padded(imgs)
    jparams = params
    if dtype == "f32":
        tol = TOL
    else:
        jmodel = JZUTIS(**CFG, dtype=jnp.bfloat16)
        jparams = jax.tree.map(
            lambda a: a.astype(jnp.bfloat16) if a.ndim > 1 else a, params)
        model = load_params(ZUTIS(**CFG, dtype=torch.bfloat16,
                                  attn_impl="torch", device="cpu"), params)
        with torch.no_grad():
            for p in model.parameters():
                if p.dim() > 1:
                    p.data = p.data.bfloat16()
        tol = dict(rtol=0, atol=2e-2)
    want = jax.jit(lambda p, x, g: jmodel.apply(
        {"params": p}, x, g, method=JZUTIS.forward_padded))(
        jparams, jnp.asarray(padded), jnp.asarray(grid))
    with torch.no_grad():
        got = model.forward_padded(torch.from_numpy(padded), grid)
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["native_grid"].numpy(),
                                  np.asarray(want["native_grid"]))
    for key in ("mask_proposals", "patch_tokens"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   err_msg=key, **tol)


def test_vit_forward_padded_matches_flax(setup):
    jmodel, params, model, imgs, _ = setup
    padded, grid, _ = _padded(imgs)
    from zutis_tpu.models.vit import CLIPViT as JCLIPViT

    jvit = JCLIPViT(width=32, layers=2, heads=2, patch_size=16, output_dim=16,
                    input_resolution=32)
    want, want_valid = jax.jit(lambda p, x, g: jvit.apply(
        {"params": p}, x, g, method=JCLIPViT.forward_padded))(
        params["encoder"], jnp.asarray(padded), jnp.asarray(grid))
    with torch.no_grad():
        got, valid = model.encoder.forward_padded(torch.from_numpy(padded),
                                                  torch.from_numpy(grid))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("attn_impl", ["auto", "torch"])
def test_forward_padded_equals_per_image(setup, attn_impl):
    """Inside the port: each valid window of the padded batch equals the
    dense forward of that image alone at its native size."""
    _, params, _, imgs, _ = setup
    model = load_params(ZUTIS(**CFG, attn_impl=attn_impl, device="cpu"), params)
    padded, grid, _ = _padded(imgs)
    with torch.no_grad():
        out_b = model.forward_padded(torch.from_numpy(padded), grid)
        for i, img in enumerate(imgs):
            out_1 = model(torch.from_numpy(img[None]), inference=True)
            h, w = out_b["native_grid"][i].tolist()
            torch.testing.assert_close(out_b["patch_tokens"][i, :h, :w],
                                       out_1["patch_tokens"][0], rtol=0, atol=2e-4)
            torch.testing.assert_close(out_b["mask_proposals"][i, -1, :, :h, :w],
                                       out_1["mask_proposals"][0, -1],
                                       rtol=0, atol=2e-4)


def _assert_step_equal(got, want):
    for key in ("keep", "category_ids", "masks"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               rtol=1e-6, atol=1e-6)
    for key, value in got["rle"].items():
        np.testing.assert_array_equal(value.numpy(), want["rle"][key],
                                      err_msg=key)


@pytest.mark.parametrize("nms_type", ["hard", "linear", "gaussian"])
def test_instance_step_matches_jax(setup, nms_type):
    jmodel, params, model, imgs, text = setup
    padded, grid, pix = _padded(imgs)
    want = _jax_step(jmodel, params, text, padded, grid, pix, nms_type=nms_type)
    step = BE.make_instance_step(model, text, BUCKET, threshold=THRESHOLD,
                                 nms_type=nms_type, device="cpu")
    got = step(padded, grid, pix)
    assert got["keep"].any(), "nothing kept: the test would check nothing"
    _assert_step_equal(got, want)
    np.testing.assert_array_equal(got["semantic"].numpy(), want["semantic"])
    for i, (h, w) in enumerate(SIZES):
        assert not got["masks"][i, :, h:, :].any()
        assert not got["masks"][i, :, :, w:].any()


def test_uint8_instance_step_matches_jax(setup):
    jmodel, params, model, _, text = setup
    rng = np.random.RandomState(3)
    u8 = [rng.randint(0, 256, (3, h, w)).astype(np.uint8) for h, w in SIZES]
    padded, grid, pix = _padded(u8, np.uint8)
    want = _jax_step(jmodel, params, text, padded, grid, pix,
                     uint8_input=True, semantic_mode="none")
    got = BE.make_instance_step(model, text, BUCKET, threshold=THRESHOLD,
                                uint8_input=True, semantic_mode="none",
                                device="cpu")(padded, grid, pix)
    assert "semantic" not in got
    _assert_step_equal(got, want)


def test_semantic_step_matches_jax(setup):
    jmodel, params, model, imgs, text = setup
    padded, grid, pix = _padded(imgs)
    want = JBE.make_semantic_step(jmodel, jnp.asarray(text), BUCKET)(
        params, *map(jnp.asarray, (padded, grid, pix)))
    got = BE.make_semantic_step(model, text, BUCKET, device="cpu")(
        padded, grid, pix)
    for i, (h, w) in enumerate(SIZES):
        np.testing.assert_array_equal(got[i, :h, :w].numpy(),
                                      np.asarray(want)[i, :h, :w])


def test_instance_step_refusals(setup):
    model, text = setup[2], setup[4]
    with pytest.raises(ValueError, match="n_classes"):
        BE.make_instance_step(model, text, BUCKET, semantic_mode="confusion",
                              device="cpu")
    with pytest.raises(ValueError, match="semantic_mode"):
        BE.make_instance_step(model, text, BUCKET, semantic_mode="dense",
                              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BE.make_instance_step(model, text, BUCKET)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            BE.evaluate_instances(model, text, [], [])


@pytest.mark.parametrize("depth", [1, 2, 3, 5])
@pytest.mark.parametrize("n", [0, 1, 2, 4, 7])
def test_pipelined_order(depth, n):
    """collect(dispatch(x), x) in work order; at most `depth` in flight;
    from depth 2 on, item N + 1 is dispatched before item N is collected."""
    trace = []

    def dispatch(x):
        trace.append(("d", x))
        return x * 10

    def collect(h, x):
        trace.append(("c", x))
        return h + x

    out = list(BE.pipelined(dispatch, collect, range(n), depth=depth))
    assert out == list(JBE.pipelined(lambda x: x * 10, lambda h, x: h + x,
                                     range(n), depth=depth))
    assert out == [x * 11 for x in range(n)]
    in_flight = 0
    for kind, _ in trace:
        in_flight += 1 if kind == "d" else -1
        assert 0 <= in_flight <= max(1, depth)
    if depth >= 2 and n >= 2:
        assert trace.index(("d", 1)) < trace.index(("c", 0))


def test_bucketing_helpers_match_jax():
    sizes = [(480, 640), (500, 600), (375, 500), (129, 129), (40, 40)]
    assert BE.group_into_buckets(sizes) == JBE.group_into_buckets(sizes)
    buckets = BE.group_into_buckets(sizes)
    assert (list(BE.iter_bucketed_batches(buckets, 1))
            == list(JBE.iter_bucketed_batches(buckets, 1)))


# evaluate_instances: 7 images, two buckets (128 x 128 and 256 x 128), three
# to a batch: a full batch of each bucket, then the partial one
EVAL_SIZES = [(48, 64), (130, 100), (100, 128), (200, 90), (64, 33),
              (129, 128), (128, 128)]
LABEL_MAP = {i: 10 + i for i in range(5)}


def _jax_eval_loop(jmodel, params, text, images, image_ids, batch_images):
    """The batched loop of zutis_tpu/cli/coco20k_eval.py, from the JAX
    package's functions, without the image files and the visualiser."""
    steps, pending, preds = {}, {}, []

    def batches():
        for image_id, img in zip(image_ids, images):
            shape = JBE.bucket_shape(*img.shape[-2:])
            pending.setdefault(shape, []).append((image_id, img))
            if len(pending[shape]) == batch_images:
                yield shape, pending.pop(shape)
        for shape, items in pending.items():
            yield shape, items

    def dispatch(batch):
        shape, items = batch
        padded, grid, pix = JBE.pad_batch([img for _, img in items], shape,
                                          batch_images, 16, dtype=np.uint8)
        if shape not in steps:
            steps[shape] = JBE.make_instance_step(
                jmodel, jnp.asarray(text), shape, threshold=THRESHOLD,
                nms_type="hard", uint8_input=True, semantic_mode="none")
        return steps[shape](params, *map(jnp.asarray, (padded, grid, pix)))

    def collect(dev, batch):
        _, items = batch
        res = unpack_host_blob(np.asarray(dev["host_blob"]))
        preds.extend(jto_coco(
            res, image_ids=[i for i, _ in items],
            sizes=[tuple(img.shape[-2:]) for _, img in items],
            new_label_id_to_old_label_id=LABEL_MAP, dev_masks=dev["masks"]))

    for _ in JBE.pipelined(dispatch, collect, batches(), depth=2):
        pass
    return preds


def _gt_from(preds, sizes_by_id):
    """A COCO ground truth of one box-filled mask per prediction, so that
    the stats are neither all 1 nor all 0."""
    anns = []
    for i, p in enumerate(preds):
        h, w = sizes_by_id[p["image_id"]]
        m = np.zeros((h, w), np.uint8)
        x0, y0, x1, y1 = (int(v) for v in p["bbox"])
        m[y0:y1 + 1, x0:x1 + 1] = 1
        anns.append({"id": i + 1, "image_id": p["image_id"],
                     "category_id": p["category_id"], "iscrowd": 0,
                     "segmentation": rle.encode(m), "area": int(m.sum())})
    return {"images": [{"id": k, "height": h, "width": w}
                       for k, (h, w) in sizes_by_id.items()],
            "annotations": anns,
            "categories": [{"id": c} for c in sorted(LABEL_MAP.values())]}


def test_evaluate_instances_matches_the_jax_loop(setup):
    jmodel, params, model, _, text = setup
    rng = np.random.RandomState(7)
    images = [rng.randint(0, 256, (3, h, w)).astype(np.uint8)
              for h, w in EVAL_SIZES]
    image_ids = [100 + i for i in range(len(images))]
    want = _jax_eval_loop(jmodel, params, text, images, image_ids, 3)
    got = BE.evaluate_instances(model, text, images, image_ids,
                                label_map=LABEL_MAP, batch_images=3, depth=2,
                                threshold=THRESHOLD, device="cpu")
    assert len(want) > 3, "too few predictions for the test to check much"
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in g:
            if key == "score":
                assert g[key] == pytest.approx(w[key], rel=1e-6, abs=1e-6)
            else:
                assert g[key] == w[key], key
    sizes_by_id = {i: s for i, s in zip(image_ids, EVAL_SIZES)}
    gt = _gt_from(want, sizes_by_id)
    stats = COCOEvaluator(gt).evaluate(got)
    assert stats == pytest.approx(JCOCOEvaluator(gt).evaluate(want), abs=1e-12)
    assert 0 < stats["AP"] < 1


@pytest.mark.parametrize("depth", [1, 2])
def test_instance_eval_bench_runs_on_the_cpu(capsys, depth):
    """The tool at the tiny config: every path gives the same number of
    predictions, and the record names the CPU."""
    import json

    from zutis_tpu_torch.tools import instance_eval_bench as bench

    records = [bench.run(batch=3, path=path, iters=1, depth=depth,
                         device="cpu", cfg=CFG, shape=BUCKET, n_categories=5,
                         windows=1, threshold=THRESHOLD)
               for path in bench.PATHS]
    printed = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert printed == records
    assert {r["n_preds_per_batch"] for r in records} == {records[0]["n_preds_per_batch"]}
    for r, path in zip(records, bench.PATHS):
        assert r["metric"] == "instance_eval_images_per_sec" and r["value"] > 0
        assert (r["path"], r["depth"], r["batch"], r["bucket"], r["device"]) == (
            path, depth, 3, list(BUCKET), "cpu")


def test_instance_eval_bench_defaults_to_the_card():
    from zutis_tpu_torch.tools import instance_eval_bench as bench

    assert bench.bench_sizes(3) == [(480, 640), (488, 624), (496, 608)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.main(["--batch", "2"])
