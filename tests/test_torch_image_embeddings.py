"""The port's image-bank path (retrieval/image_embeddings.py) against the
JAX package's (zutis_tpu/retrieval/image_embeddings.py, which runs Pillow):

  * clip_preprocess bit-equal on every committed fixture (JPEG gray, RGB
    and CMYK; PNG 1-bit, gray, gray + alpha, palette, RGB, RGBA) at several
    resolutions, on odd aspect ratios, and on random gray + alpha and RGBA
    images with every alpha level; the CMYK fixture shows that resizing
    before the RGB conversion matters; a mode the port does not decode
    raises;
  * extract_image_embeddings and PASS.ensure_bank: the banks hold the same
    keys in the same order and embeddings equal to the JAX ones
    (rtol 2e-4, atol 2e-5) from a tiny CLIPViT carried across by the
    weights bridge, with a short last batch padded.
"""
import pickle
import shutil
from functools import partial
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from zutis_tpu.data.imagenet_index import PASS as JaxPASS
from zutis_tpu.models.vit import CLIPViT as JaxViT
from zutis_tpu.retrieval import image_embeddings as jie
from zutis_tpu_torch.data.imagenet_index import PASS
from zutis_tpu_torch.models.vit import CLIPViT
from zutis_tpu_torch.models.weights import visual_params_from_jax
from zutis_tpu_torch.retrieval import image_embeddings as ie

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
FIXTURE_FILES = sorted(p.name for p in FIXTURES.iterdir()
                       if p.suffix in (".jpg", ".png"))
RTOL, ATOL = 2e-4, 2e-5
VIT = dict(width=32, layers=1, heads=2, patch_size=8, output_dim=16,
           input_resolution=32)


def _pillow(path, resolution):
    with Image.open(path) as im:
        return jie.clip_preprocess(im, resolution)


def test_constants_equal_jax():
    np.testing.assert_array_equal(ie.CLIP_MEAN, jie.CLIP_MEAN)
    np.testing.assert_array_equal(ie.CLIP_STD, jie.CLIP_STD)


@pytest.mark.parametrize("name", FIXTURE_FILES)
def test_clip_preprocess_bit_equal_on_the_fixtures(name):
    for resolution in (1, 7, 16, 33, 336):
        got = ie.clip_preprocess(FIXTURES / name, resolution)
        want = _pillow(FIXTURES / name, resolution)
        assert got.dtype == np.float32
        assert got.shape == want.shape == (3, resolution, resolution)
        np.testing.assert_array_equal(got, want, err_msg=f"{name} @ "
                                                         f"{resolution}")


def test_cmyk_resizes_before_it_converts():
    """Pillow resizes the CMYK samples, then converts: converting first
    gives other bytes, so the order is pinned."""
    path = FIXTURES / "cmyk_q90_40x24.jpg"
    with Image.open(path) as im:
        assert im.mode == "CMYK"
        differs = []
        for r in (7, 16, 33):
            w, h = im.size
            size = (int(r * w / h), r) if w > h else (r, int(r * h / w))
            a = np.asarray(im.resize(size, Image.BICUBIC).convert("RGB"))
            b = np.asarray(im.convert("RGB").resize(size, Image.BICUBIC))
            differs.append(not np.array_equal(a, b))
    assert any(differs)


def test_cmyk_converts_to_rgb_in_one_place():
    """The native decoder gives a CMYK JPEG only as Pillow's "CMYK"
    samples; `read_rgb` converts them with `to_rgb`, equal to Pillow's."""
    from zutis_tpu_torch.data.image_io import open_image, read_rgb, to_rgb
    from zutis_tpu_torch.native import image as native_image

    path = FIXTURES / "cmyk_q90_40x24.jpg"
    with pytest.raises(ValueError, match="four-component"):
        native_image.decode_jpeg_rgb(path.read_bytes())
    arr, mode, _ = open_image(path)
    assert mode == "CMYK" and arr.shape == (24, 40, 4)
    with Image.open(path) as im:
        np.testing.assert_array_equal(arr, np.asarray(im))
        np.testing.assert_array_equal(read_rgb(path),
                                      np.asarray(im.convert("RGB")))
    np.testing.assert_array_equal(read_rgb(path), to_rgb(arr, mode))


@pytest.mark.parametrize("h,w", [(3, 200), (200, 3), (101, 100), (33, 65),
                                 (1, 1), (64, 64), (17, 400)])
@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "LA", "P", "1"])
def test_clip_preprocess_bit_equal_on_odd_shapes(tmp_path, h, w, mode):
    rng = np.random.default_rng(h * 1000 + w)
    rgba = rng.integers(0, 256, (h, w, 4), np.uint8)
    rgba[..., 3].flat[:6] = (0, 255, 1, 254, 128, 0)[:rgba[..., 3].size]
    im = Image.fromarray(rgba, "RGBA")
    if mode == "P":
        im = im.convert("RGB").quantize(17)
    elif mode != "RGBA":
        im = im.convert(mode)
    path = tmp_path / "im.png"
    im.save(path)
    with Image.open(path) as reread:
        assert reread.mode == mode
    for resolution in (5, 32, 47):
        np.testing.assert_array_equal(ie.clip_preprocess(path, resolution),
                                      _pillow(path, resolution))


def test_clip_preprocess_refuses_what_it_does_not_decode(tmp_path):
    path = tmp_path / "deep.png"
    Image.fromarray(np.arange(64, dtype=np.uint16).reshape(8, 8) * 999
                    ).save(path)
    with pytest.raises(ValueError, match="16-bit"):
        ie.clip_preprocess(path, 8)
    with pytest.raises(ValueError, match="mode 'I'"):
        ie.resize_bicubic_as_pillow(np.zeros((4, 4), np.int32), "I", (2, 2))


@pytest.fixture(scope="module")
def encoders():
    jm = JaxViT(**VIT)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(5), jnp.zeros((1, 3, 32, 32)))["params"])
    ours = CLIPViT(**VIT, device="cpu")
    ours.load_state_dict(visual_params_from_jax(params), strict=True)
    return jm, params, ours


def _paths():
    names = [n for n in FIXTURE_FILES if n.endswith(".jpg")][:7]
    return [str(FIXTURES / n) for n in names]


def _assert_banks_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def test_extract_image_embeddings_equals_jax(tmp_path, encoders):
    jm, params, ours = encoders
    paths = _paths()
    fps = [str(tmp_path / "jax.pkl"), str(tmp_path / "port.pkl")]
    want = jie.extract_image_embeddings(paths, jm, params, resolution=32,
                                        batch_size=3, fp=fps[0])
    got = ie.extract_image_embeddings(paths, ours, resolution=32,
                                      batch_size=3, fp=fps[1])
    _assert_banks_equal(got, want)
    for e in got.values():
        np.testing.assert_allclose(np.linalg.norm(e), 1.0, rtol=1e-5)
    with open(fps[0], "rb") as f0, open(fps[1], "rb") as f1:
        _assert_banks_equal(pickle.load(f1), pickle.load(f0))


def test_padding_the_last_batch_changes_nothing(encoders):
    _, _, ours = encoders
    paths = [str(FIXTURES / n) for n in FIXTURE_FILES[:5]]
    whole = ie.encode_images(paths, ours, 32)
    padded = ie.encode_images(paths, ours, 32, batch_size=8)
    assert padded.shape == whole.shape == (5, 16)
    np.testing.assert_allclose(padded, whole, rtol=1e-5, atol=1e-6)


def test_pass_ensure_bank_equals_jax(tmp_path, encoders):
    jm, params, ours = encoders
    encode = jax.jit(lambda x: jm.apply({"params": params}, x,
                                        method=JaxViT.encode_image))

    def jax_encode_fn(chunk):
        return np.array(encode(np.stack([_pillow(p, 32) for p in chunk])))

    banks = {}
    for side, cls, fn in (
            ("jax", JaxPASS, jax_encode_fn),
            ("port", PASS, partial(ie.encode_images, visual_encoder=ours,
                                   resolution=32))):
        root = tmp_path / side
        for part, p in enumerate(_paths()):
            dst = root / "images" / str(part % 2) / f"img{part}.jpg"
            dst.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(p, dst)
        fp = cls(str(root)).ensure_bank(fn, batch_size=3)
        with open(fp, "rb") as f:
            banks[side] = pickle.load(f)
        assert cls(str(root)).ensure_bank(None) == fp  # no second extraction
    assert list(banks["port"])[0] == "0/img0.jpg"
    _assert_banks_equal(banks["port"], banks["jax"])
    with pytest.raises(ValueError, match="encode_fn"):
        PASS(str(tmp_path / "empty")).ensure_bank(None)


def test_encode_images_runs_on_the_encoders_device(encoders):
    _, _, ours = encoders
    emb = ie.encode_images([str(FIXTURES / FIXTURE_FILES[0])], ours, 32)
    assert isinstance(emb, np.ndarray) and emb.dtype == np.float32
    assert ours.proj.device == torch.device("cpu")
