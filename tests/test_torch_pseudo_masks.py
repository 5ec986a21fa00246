"""The port's pseudo-mask generation (zutis_tpu_torch/data/pseudo_masks.py)
against the JAX package's (zutis_tpu/data/pseudo_masks.py) on the CPU, with
the same tiny SelfMask weights through the bridge, on committed fixture
JPEGs (500 x 375 and 640 x 480 photos, gray, 257 x 191):

  * the JSON files byte-equal to the JAX ones at the default 512 and at
    128, in the flat `<dir>/<stem>.json` layout and in a `path_map` layout,
    with and without the bilateral solver. Where a file differs, the
    SelfMask masks must differ only at pixels within 1e-5 of 0.5 (a
    near-tie, reported), and the port's solver on the JAX mask must then
    give the JAX file;
  * existing files reused untouched, `overwrite` rewriting them;
  * Pillow's NEAREST resize back to the original size bit-equal to Pillow
    across up- and down-scales.
"""
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from zutis_tpu.data import pseudo_masks as jax_pm
from zutis_tpu.models.selfmask import SelfMask as JaxSelfMask
from zutis_tpu.models.selfmask import pad_to_patch_multiple as jax_pad
from zutis_tpu_torch.data import pseudo_masks as pm
from zutis_tpu_torch.models.selfmask import SelfMask
from zutis_tpu_torch.models.weights import selfmask_params_from_jax
from zutis_tpu_torch.ops import bilateral, rle

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
TINY = dict(n_queries=4, patch_size=8, n_decoder_layers=1, embed_dim=32,
            heads=2, base_grid=4, depth=1)
NEAR_TIE = 1e-5  # of 0.5, in SelfMask's f32 probability
PHOTOS = [str(p) for p in sorted(FIXTURES.glob("photo_*_420_q75.jpg"))]
LARGEST = str(FIXTURES / "largest_640x480_422_q80_progressive.jpg")
OTHERS = [str(FIXTURES / n) for n in ("gray_q90_progressive_100x75.jpg",
                                      "rgb_420_q80_progressive_257x191.jpg",
                                      "cmyk_q90_40x24.jpg")]


@pytest.fixture(scope="module")
def models():
    jm = JaxSelfMask(**TINY)
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 32, 32)))["params"])
    ours = SelfMask(**TINY, device="cpu")
    ours.load_state_dict(selfmask_params_from_jax(params), strict=True)
    return jm, params, ours


def _jax_selfmask(jm, params, resized):
    """The JAX generator's SelfMask step on one resized image."""
    from zutis_tpu.data.transforms import normalize_image

    arr = normalize_image(resized)[None]
    h, w = arr.shape[-2:]
    return np.asarray(jm.apply({"params": params}, jnp.asarray(
        jax_pad(arr, 8)), method=JaxSelfMask.best_masks))[0, :h, :w]


def _assert_files_equal(models, paths, want, got, image_size,
                        use_bilateral_solver=True):
    """Byte-equal files, or a reported SelfMask near-tie after which the
    port's solver on the JAX mask gives the JAX file."""
    jm, params, ours = models
    for p in paths:
        a, b = Path(want[p]).read_bytes(), Path(got[p]).read_bytes()
        if a == b:
            continue
        size, resized = pm.load_resized(p, image_size)
        mask = pm.selfmask_mask(ours, resized, "cpu")
        jax_mask = _jax_selfmask(jm, params, resized)
        differ = mask != jax_mask
        arr = torch.from_numpy(pm.pad_to_patch_multiple(
            pm.normalize_image(resized)[None], 8))
        with torch.no_grad():
            out = ours(arr)
        up = torch.nn.functional.interpolate(
            out["mask_pred"], scale_factor=4, mode="bilinear")
        prob = up[0, int(out["objectness"].argmax())].numpy()[
            :mask.shape[0], :mask.shape[1]]
        print(f"{p}: SelfMask near-tie at {int(differ.sum())} pixels, "
              f"within {np.abs(prob[differ] - 0.5).max():.2e} of 0.5")
        assert differ.any() and (np.abs(prob[differ] - 0.5) <= NEAR_TIE).all()
        if use_bilateral_solver:
            _, jax_mask = bilateral.bilateral_solver_output(
                resized, jax_mask.astype(np.float64), device="cpu")
        final = pm.to_original_size(jax_mask.astype(np.uint8), size)
        np.testing.assert_array_equal(final, rle.decode(json.loads(a)))


@pytest.mark.parametrize("image_size,paths", [
    (512, PHOTOS[:2] + [LARGEST]),
    (128, PHOTOS + [LARGEST] + OTHERS),
])
def test_flat_layout_equals_jax(models, tmp_path, image_size, paths):
    jm, params, ours = models
    want = jax_pm.generate_pseudo_masks(paths, str(tmp_path / "jax"), params,
                                        model=jm, image_size=image_size)
    got = pm.generate_pseudo_masks(paths, str(tmp_path / "port"), ours,
                                   image_size=image_size, device="cpu")
    assert list(got) == paths
    assert got == {p: pm.pseudo_mask_path(str(tmp_path / "port"), p)
                   for p in paths}
    _assert_files_equal(models, paths, want, got, image_size)
    areas = [rle.decode(json.loads(Path(got[p]).read_text())).mean()
             for p in paths]
    assert any(0 < a < 1 for a in areas), areas  # not all trivial masks


def test_path_map_layout_equals_jax(models, tmp_path):
    jm, params, ours = models
    paths = PHOTOS[2:] + OTHERS[:2]

    def layout(root):
        return {p: str(root / f"wnid{i % 2}" / "deep" / f"m{i}.json")
                for i, p in enumerate(paths)}

    want = jax_pm.generate_pseudo_masks(paths, "", params, model=jm,
                                        image_size=96,
                                        path_map=layout(tmp_path / "jax"))
    got = pm.generate_pseudo_masks(paths, "", ours, image_size=96,
                                   path_map=layout(tmp_path / "port"),
                                   device="cpu")
    assert got == layout(tmp_path / "port")
    _assert_files_equal(models, paths, want, got, 96)


def test_without_the_solver_equals_jax(models, tmp_path):
    jm, params, ours = models
    paths = PHOTOS[:3]
    want = jax_pm.generate_pseudo_masks(paths, str(tmp_path / "jax"), params,
                                        model=jm, image_size=64,
                                        use_bilateral_solver=False)
    got = pm.generate_pseudo_masks(paths, str(tmp_path / "port"), ours,
                                   image_size=64, use_bilateral_solver=False,
                                   device="cpu")
    _assert_files_equal(models, paths, want, got, 64,
                        use_bilateral_solver=False)


def test_existing_files_are_reused_and_overwrite_rewrites(models, tmp_path):
    _, _, ours = models
    paths = PHOTOS[:2]
    out = pm.generate_pseudo_masks(paths, str(tmp_path), ours, image_size=64,
                                   device="cpu")
    first = {p: (os.stat(f).st_mtime_ns, Path(f).read_bytes())
             for p, f in out.items()}
    # a stale file is kept as it is unless overwritten
    Path(out[paths[1]]).write_text(json.dumps(rle.encode(
        np.ones((375, 500), np.uint8))))
    stale = Path(out[paths[1]]).read_bytes()
    stale_ns = os.stat(out[paths[1]]).st_mtime_ns
    again = pm.generate_pseudo_masks(paths, str(tmp_path), ours,
                                     image_size=64, device="cpu")
    assert again == out
    assert os.stat(out[paths[0]]).st_mtime_ns == first[paths[0]][0]
    assert (os.stat(out[paths[1]]).st_mtime_ns, Path(out[paths[1]])
            .read_bytes()) == (stale_ns, stale)
    pm.generate_pseudo_masks(paths, str(tmp_path), ours, image_size=64,
                             overwrite=True, device="cpu")
    for p, (_, data) in first.items():
        assert Path(out[p]).read_bytes() == data


def test_a_model_on_another_device_is_refused(models, tmp_path):
    _, _, ours = models
    with pytest.raises(ValueError, match="lies on cpu"):
        pm.generate_pseudo_masks(PHOTOS[:1], str(tmp_path), ours,
                                 device="meta")


@pytest.mark.parametrize("src,dst", [
    ((512, 683), (375, 500)), ((512, 683), (480, 640)), ((64, 86), (75, 100)),
    ((96, 128), (24, 40)), ((37, 23), (111, 70)), ((5, 3), (1, 1)),
    ((1, 1), (7, 9)), ((512, 512), (1024, 333)),
])
def test_nearest_back_to_the_original_size_equals_pillow(src, dst):
    mask = (np.random.default_rng(src[0] * dst[1]).random(src) < 0.4
            ).astype(np.uint8)
    want = np.asarray(Image.fromarray(mask * 255).resize(
        (dst[1], dst[0]), Image.NEAREST)) > 127
    np.testing.assert_array_equal(pm.to_original_size(mask, dst),
                                  want.astype(np.uint8))
