"""The slice as a whole: the port's InferenceServer (device="cpu") against
the JAX InferenceServer at the tiny config of tests/test_server.py, with the
flax parameters carried across. Semantic maps, kept instances, category ids
and RLE strings (or, with encode_rle=False, boolean masks) must be equal;
scores agree within 1e-5 (f32 summation order). The queued API is also held
to the JAX server's answers when a client cancels requests while they wait
in the queue."""
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from zutis_tpu.data.transforms import normalize_image
from zutis_tpu.engine.server import InferenceServer as JInferenceServer
from zutis_tpu.models.zutis import ZUTIS as JZUTIS
from zutis_tpu_torch.engine.server import InferenceServer
from zutis_tpu_torch.models.weights import load_params
from zutis_tpu_torch.models.zutis import ZUTIS
from zutis_tpu_torch.ops import rle as trle

CFG = dict(width=32, encoder_layers=1, encoder_heads=2, patch_size=16,
           text_dim=16, n_queries=6, n_decoder_layers=1, n_heads=2,
           input_resolution=32)
SERVER = dict(image_size=32, batch_size=4, threshold=0.4)


@pytest.fixture(scope="module")
def parts():
    jmodel = JZUTIS(**CFG)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))["params"]
    params = jax.tree.map(np.asarray, params)
    rng = np.random.RandomState(0)
    text = rng.randn(4, 16).astype(np.float32)
    text /= np.linalg.norm(text, axis=1, keepdims=True)
    images = [rng.randn(3, 32, 32).astype(np.float32) for _ in range(7)]
    model = load_params(ZUTIS(**CFG, device="cpu"), params)
    return jmodel, params, model, text, images


def _assert_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["semantic"], w["semantic"])
        assert len(g["instances"]) == len(w["instances"])
        for gi, wi in zip(g["instances"], w["instances"]):
            assert gi["category_id"] == wi["category_id"]
            assert gi["segmentation"] == wi["segmentation"]
            np.testing.assert_allclose(gi["score"], wi["score"], rtol=0,
                                       atol=1e-5)


def test_sync_infer_matches_jax_server(parts):
    jmodel, params, model, text, images = parts
    want = JInferenceServer(jmodel, params, jnp.asarray(text), **SERVER).infer(images)
    srv = InferenceServer(model, text, device="cpu", **SERVER)
    got = srv.infer(images)  # 7 images: a batch of 4 and a padded one of 3
    assert srv.batches == 2
    _assert_same(got, want)
    assert sum(len(r["instances"]) for r in got) > 0, "no instance compared"
    for r in got:
        assert r["semantic"].shape == (4, 4) and r["semantic"].dtype == np.int32
        for inst in r["instances"]:
            assert trle.decode(inst["segmentation"]).shape == (4, 4)


def test_async_submit_matches_jax_server(parts):
    jmodel, params, model, text, images = parts
    want = JInferenceServer(jmodel, params, jnp.asarray(text), **SERVER).infer(images)
    srv = InferenceServer(model, text, device="cpu", max_wait_ms=20, **SERVER)
    srv.start()
    try:
        futures = [srv.submit(img) for img in images]
        got = [f.result(timeout=120) for f in futures]
    finally:
        srv.stop()
    _assert_same(got, want)
    with pytest.raises(RuntimeError):
        srv.submit(images[0])  # stopped


def test_uint8_transport_matches_jax_server(parts):
    jmodel, params, model, text, _ = parts
    rng = np.random.RandomState(7)
    raw = [rng.randint(0, 256, (3, 32, 32)).astype(np.uint8) for _ in range(3)]
    want = JInferenceServer(jmodel, params, jnp.asarray(text),
                            uint8_transport=True, **SERVER).infer(raw)
    srv = InferenceServer(model, text, device="cpu", uint8_transport=True,
                          **SERVER)
    _assert_same(srv.infer(raw), want)
    # and the on-device normalisation agrees with the host's f32 one
    norm = [normalize_image(r.transpose(1, 2, 0)) for r in raw]
    f32 = InferenceServer(model, text, device="cpu", **SERVER).infer(norm)
    for g, w in zip(srv.infer(raw), f32):
        assert (g["semantic"] != w["semantic"]).mean() < 5e-3


@pytest.mark.parametrize("nms_type", ["linear", "gaussian"])
def test_soft_nms_server_matches_jax_server(parts, nms_type):
    jmodel, params, model, text, images = parts
    want = JInferenceServer(jmodel, params, jnp.asarray(text),
                            nms_type=nms_type, **SERVER).infer(images[:4])
    got = InferenceServer(model, text, device="cpu", nms_type=nms_type,
                          **SERVER).infer(images[:4])
    _assert_same(got, want)


def test_server_rejects_requests_of_another_size(parts):
    _, _, model, text, images = parts
    srv = InferenceServer(model, text, device="cpu", **SERVER)
    with pytest.raises(ValueError, match="shape"):
        srv.infer([images[0], np.zeros((3, 16, 16), np.float32)])
    assert srv.batches == 0


@pytest.fixture(scope="module")
def jax_answers(parts):
    """The JAX server's answers to the module's 7 images, one per image."""
    jmodel, params, _, text, images = parts
    return JInferenceServer(jmodel, params, jnp.asarray(text), **SERVER).infer(images)


def _held_server(model, text):
    """A started server whose worker blocks inside its first infer() until
    the returned event is set, so that later requests stay queued; `calls`
    records the images of every infer() the worker makes."""
    srv = InferenceServer(model, text, device="cpu", max_wait_ms=20, **SERVER)
    gate, calls, infer = threading.Event(), [], srv.infer

    def held_infer(images):
        calls.append(list(images))
        assert gate.wait(timeout=120)
        return infer(images)

    srv.infer = held_infer
    srv.start()
    return srv, gate, calls


def _wait_for(cond, timeout=60.0):
    t0 = time.monotonic()
    while not cond():
        assert time.monotonic() - t0 < timeout, "the worker did not get there"
        time.sleep(0.01)


def test_cancelled_request_leaves_the_worker_and_its_batch_alive(
        parts, jax_answers):
    _, _, model, text, images = parts
    srv, gate, calls = _held_server(model, text)
    try:
        first = srv.submit(images[0])
        _wait_for(lambda: len(calls) == 1)  # the worker holds image 0
        queued = [srv.submit(images[i]) for i in range(1, 5)]  # a full batch
        assert queued[1].cancel()  # image 2, still queued
        gate.set()
        got = [f.result(timeout=120) for f in (first, queued[0], queued[2],
                                               queued[3])]
        later = srv.submit(images[5]).result(timeout=120)
        assert srv._worker.is_alive()
    finally:
        gate.set()
        srv.stop()
    assert queued[1].cancelled()
    _assert_same(got + [later], [jax_answers[i] for i in (0, 1, 3, 4, 5)])
    assert [len(c) for c in calls] == [1, 3, 1]  # image 2 dropped
    assert srv.batches == 3


def test_batch_of_cancelled_requests_runs_no_step(parts, jax_answers):
    _, _, model, text, images = parts
    srv, gate, calls = _held_server(model, text)
    try:
        first = srv.submit(images[0])
        _wait_for(lambda: len(calls) == 1)
        queued = [srv.submit(images[i]) for i in range(1, 5)]  # a full batch
        assert all(f.cancel() for f in queued)
        gate.set()
        got = [first.result(timeout=120),
               srv.submit(images[6]).result(timeout=120)]
        assert srv._worker.is_alive()
    finally:
        gate.set()
        srv.stop()
    _assert_same(got, [jax_answers[0], jax_answers[6]])
    assert [len(c) for c in calls] == [1, 1] and srv.batches == 2


@pytest.mark.parametrize("nms_type", ["hard", "linear", "gaussian"])
def test_masks_without_rle_match_jax_server(parts, nms_type):
    jmodel, params, model, text, images = parts
    want = JInferenceServer(jmodel, params, jnp.asarray(text), encode_rle=False,
                            nms_type=nms_type, **SERVER).infer(images[:4])
    got = InferenceServer(model, text, device="cpu", encode_rle=False,
                          nms_type=nms_type, **SERVER).infer(images[:4])
    assert sum(len(r["instances"]) for r in got) > 0, "no instance compared"
    for g, w in zip(got, want, strict=True):
        np.testing.assert_array_equal(g["semantic"], w["semantic"])
        assert len(g["instances"]) == len(w["instances"])
        for gi, wi in zip(g["instances"], w["instances"]):
            assert set(gi) == set(wi) == {"category_id", "score", "mask"}
            assert gi["category_id"] == wi["category_id"]
            assert gi["mask"].dtype == bool and gi["mask"].shape == (4, 4)
            np.testing.assert_array_equal(gi["mask"], wi["mask"])
            np.testing.assert_allclose(gi["score"], wi["score"], rtol=0,
                                       atol=1e-5)


def test_default_rle_decodes_to_the_masks(parts):
    _, _, model, text, images = parts
    rle = InferenceServer(model, text, device="cpu", **SERVER).infer(images)
    masks = InferenceServer(model, text, device="cpu", encode_rle=False,
                            **SERVER).infer(images)
    assert sum(len(r["instances"]) for r in rle) > 0, "no instance compared"
    for r, m in zip(rle, masks, strict=True):
        assert len(r["instances"]) == len(m["instances"])
        for ri, mi in zip(r["instances"], m["instances"]):
            assert "mask" not in ri and "segmentation" not in mi
            np.testing.assert_array_equal(
                trle.decode(ri["segmentation"]).astype(bool), mi["mask"])


def test_server_without_device_raises_on_a_host_without_cuda(parts):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    _, _, model, text, _ = parts
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceServer(model, text, **SERVER)
