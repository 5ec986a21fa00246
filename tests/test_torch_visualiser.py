"""The port's figures (zutis_tpu_torch/engine/visualiser.py) against the JAX
package's matplotlib ones (zutis_tpu/engine/visualiser.py) on numpy-seeded
inputs:

  * the palette and image helpers bit-equal, `ignore_index` and a palette
    of 919 included;
  * each figure's panels equal to the arrays the JAX function hands to
    `Axes.imshow` (recorded by wrapping it), the heat-maps through
    matplotlib's own colormap at vmin 0, vmax 1, bin edges included; the
    titles equal to its `set_title` strings, the overlay's labels to its
    `text` calls, anchor included;
  * the overlay PNG bit-equal to the JAX canvas outside the label boxes;
  * every PNG decoding through the port's `read_png` and through Pillow to
    the composed array; `matched_pairs` with no rows drawing nothing
    (None), where the JAX one writes no file.
"""
import os

import matplotlib
import numpy as np
import pytest
from matplotlib import colormaps
from matplotlib.colors import Normalize
from PIL import Image

from zutis_tpu.engine import visualiser as J
from zutis_tpu_torch.data.image_io import read_png, write_png
from zutis_tpu_torch.engine import visualiser as V


@pytest.fixture
def drawn(monkeypatch):
    """What the JAX figures hand matplotlib: ("imshow", array, kwargs),
    ("title", text) and ("text", x, y, s) in call order."""
    calls = []
    axes = matplotlib.axes.Axes
    imshow, set_title, text = axes.imshow, axes.set_title, axes.text

    def rec_imshow(self, X, *a, **k):
        calls.append(("imshow", np.array(X), k))
        return imshow(self, X, *a, **k)

    def rec_title(self, label, *a, **k):
        calls.append(("title", label))
        return set_title(self, label, *a, **k)

    def rec_text(self, x, y, s, *a, **k):
        calls.append(("text", x, y, s))
        return text(self, x, y, s, *a, **k)

    monkeypatch.setattr(axes, "imshow", rec_imshow)
    monkeypatch.setattr(axes, "set_title", rec_title)
    monkeypatch.setattr(axes, "text", rec_text)
    return calls


def _panel(call):
    """The [h, w, 3] uint8 image matplotlib draws for an imshow call."""
    _, X, k = call
    if "cmap" not in k:
        return X
    rgba = colormaps[k["cmap"]](Normalize(k["vmin"], k["vmax"])(X), bytes=True)
    return rgba[..., :3]


def _check_panels(canvas, calls, n_cols, n_cells=None):
    """The canvas holds each imshow'd panel where `layout` puts it, in
    call order, and nothing is shown where the JAX figure shows nothing."""
    shows = [c for c in calls if c[0] == "imshow"]
    titles = [c[1] for c in calls if c[0] == "title"]
    cells = [(t, *s[1].shape[:2]) for t, s in zip(titles, shows)]
    cells += [None] * ((n_cells or len(cells)) - len(cells))
    shape, origins = V.layout(cells, n_cols)
    assert canvas.shape == (*shape, 3)
    for call, (y0, x0) in zip(shows, origins):
        want = _panel(call)
        h, w = want.shape[:2]
        np.testing.assert_array_equal(canvas[y0:y0 + h, x0:x0 + w], want)


def _check_png(fp, canvas):
    np.testing.assert_array_equal(read_png(fp), canvas)
    np.testing.assert_array_equal(np.asarray(Image.open(fp)), canvas)


# ------------------------------------------------------------ helpers

@pytest.mark.parametrize("n", [1, 2, 5, 80, 918])
def test_distinct_colors_equal_jax(n):
    assert V.distinct_colors(n) == J.distinct_colors(n)


@pytest.mark.parametrize("n", [2, 21, 81, 919])
def test_palette_equals_jax(n):
    assert V.get_palette(n) == J.get_palette(n)


@pytest.mark.parametrize("ignore_index", [None, 255])
def test_colourise_mask_equals_jax(ignore_index):
    rng = np.random.default_rng(0)
    mask = rng.integers(0, 919, (37, 53)).astype(np.int32)
    mask[rng.random((37, 53)) < 0.1] = 255 if ignore_index else 0
    palette = V.get_palette(919)
    got = V.colourise_mask(mask, palette, ignore_index)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, J.colourise_mask(mask, J.get_palette(919), ignore_index))


def test_denormalise_image_equals_jax():
    image = (np.random.default_rng(1).standard_normal((3, 29, 41)) * 2
             ).astype(np.float32)
    got = V.denormalise_image(image)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, J.denormalise_image(image))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name,table", [("viridis", V.VIRIDIS),
                                        ("gray", V.GRAY)])
def test_heatmap_is_matplotlibs_colormap(dtype, name, table):
    edges = np.arange(257, dtype=dtype) / 256
    x = np.concatenate([edges, np.nextafter(edges, dtype(-1)),
                        np.nextafter(edges, dtype(2)),
                        np.array([-1, -1e-9, 1, 1 + 1e-7, 3], dtype),
                        np.random.default_rng(2).random(300).astype(dtype)])
    want = colormaps[name](Normalize(0, 1)(x), bytes=True)[..., :3]
    np.testing.assert_array_equal(V.heatmap(x, table), want)
    boolean = np.array([[True, False]])
    np.testing.assert_array_equal(
        V.heatmap(boolean, table),
        colormaps[name](Normalize(0, 1)(boolean), bytes=True)[..., :3])


def test_font_covers_the_titles_and_labels():
    assert all(len(g) == V.GLYPH_H and max(g) < 32 for g in V.GLYPHS.values())
    for ch in "abcdefghijklmnopqrstuvwxyz0123456789 .-":
        assert ch in V.GLYPHS
    bitmap = V.text_bitmap("gt 7")
    assert bitmap.shape == (V.GLYPH_H, 4 * V.ADVANCE - 1)
    assert not bitmap[:, V.ADVANCE * 2:V.ADVANCE * 3 - 1].any()  # the space
    box = V.text_bitmap("?")  # a character outside the font: a box
    assert box[0].all() and box[-1].all() and box[:, 0].all()


# ------------------------------------------------------------ figures

def test_semantic_triptych_draws_the_jax_panels(drawn, tmp_path):
    rng = np.random.default_rng(3)
    image = rng.standard_normal((3, 48, 40)).astype(np.float32)
    gt = rng.integers(0, 6, (48, 40)).astype(np.int32)
    gt[:5] = 255
    pred = rng.integers(0, 6, (48, 40)).astype(np.int64)
    J.semantic_triptych(image, gt, pred, J.get_palette(6),
                        str(tmp_path / "jax.png"), ignore_index=255)
    fp = str(tmp_path / "port.png")
    canvas, labels = V.semantic_triptych(image, gt, pred, V.get_palette(6),
                                         ignore_index=255)
    write_png(fp, canvas)
    assert [t for t, _, _ in labels] == [c[1] for c in drawn
                                          if c[0] == "title"]
    _check_panels(canvas, drawn, 3)
    _check_png(fp, canvas)


@pytest.mark.parametrize("q", [7, 10, 13])
def test_query_grid_draws_the_jax_panels(drawn, tmp_path, q):
    rng = np.random.default_rng(q)
    proposals = rng.random((q, 24, 20)).astype(np.float32)
    proposals[0, 0, :3] = (0.0, 1.0, 0.5)
    J.query_grid(proposals, str(tmp_path / "jax.png"))
    fp = str(tmp_path / "port.png")
    canvas, labels = V.query_grid(proposals)
    write_png(fp, canvas)
    assert [t for t, _, _ in labels] == [c[1] for c in drawn
                                          if c[0] == "title"]
    assert [c[2] for c in drawn if c[0] == "imshow"] == [
        dict(vmin=0, vmax=1, cmap="viridis")] * q
    _check_panels(canvas, drawn, 10, n_cells=(q + 9) // 10 * 10)
    _check_png(fp, canvas)


def test_matched_pairs_draws_the_jax_panels(drawn, tmp_path):
    rng = np.random.default_rng(4)
    gt = (rng.random((3, 40, 36)) > 0.5).astype(np.float32)
    proposals = rng.random((9, 40, 36)).astype(np.float32)
    assignment = [4, 0, 8]
    J.matched_pairs(gt, proposals, assignment, str(tmp_path / "jax.png"))
    fp = str(tmp_path / "port.png")
    canvas, labels = V.matched_pairs(gt, proposals, assignment)
    write_png(fp, canvas)
    assert [t for t, _, _ in labels] == [c[1] for c in drawn
                                          if c[0] == "title"] == [
        "gt 0", "query 4", "gt 1", "query 0", "gt 2", "query 8"]
    _check_panels(canvas, drawn, 2)
    _check_png(fp, canvas)


def test_matched_pairs_with_no_rows_writes_nothing(tmp_path):
    gt, proposals = np.zeros((0, 8, 8), np.float32), np.zeros((3, 8, 8))
    J.matched_pairs(gt, proposals, [], str(tmp_path / "jax.png"))
    assert os.listdir(tmp_path) == []
    assert V.matched_pairs(gt, proposals, []) is None


def test_instance_overlay_is_the_jax_canvas(drawn, tmp_path):
    rng = np.random.default_rng(5)
    H, W = 60, 70
    image = rng.standard_normal((3, H, W)).astype(np.float32)
    masks = np.zeros((4, H, W), bool)
    masks[0, 5:30, 3:40] = True
    masks[1, 20:58, 30:69] = True  # overlaps the first
    masks[2, 50:60, 60:70] = True  # its label runs past the right edge
    scores, labels = [0.913, 0.5, 0.04, 0.7], ["17", "3", "80", "1"]
    J.instance_overlay(image, masks, scores, labels,
                       str(tmp_path / "jax.png"))
    fp = str(tmp_path / "port.png")
    canvas, got = V.instance_overlay(image, masks, scores, labels)
    write_png(fp, canvas)
    want_canvas = next(c[1] for c in drawn if c[0] == "imshow")
    want = [(s, x, y) for _, x, y, s in (c for c in drawn if c[0] == "text")]
    assert got == want and len(got) == 3  # the empty mask has no label
    assert got[0][0] == "17 0.91"
    outside = np.ones((H, W), bool)
    for text, x, y in got:
        y0, y1, x0, x1 = V.label_box(text, int(round(x)), int(round(y)))
        outside[max(y0, 0):y1, max(x0, 0):x1] = False
    assert outside.mean() > 0.8
    _check_png(fp, canvas)
    np.testing.assert_array_equal(read_png(fp)[outside], want_canvas[outside])
    assert (canvas[~outside] != want_canvas[~outside]).any()


def test_instance_overlay_skips_masks_of_another_size(tmp_path):
    image = np.zeros((3, 20, 24), np.float32)
    masks = np.ones((1, 16, 24), bool)
    canvas, _ = V.instance_overlay(image, masks, [0.5], ["1"])
    np.testing.assert_array_equal(canvas[-3:], V.denormalise_image(image)[-3:])


# ------------------------------------------------------------ PNG

@pytest.mark.parametrize("shape", [(1, 1, 3), (17, 5, 3), (64, 300, 3)])
def test_write_png_round_trips(tmp_path, shape):
    rgb = np.random.default_rng(6).integers(0, 256, shape).astype(np.uint8)
    fp = tmp_path / "x.png"
    write_png(fp, rgb)
    _check_png(fp, rgb)


@pytest.mark.parametrize("bad", [np.zeros((4, 4), np.uint8),
                                 np.zeros((4, 4, 4), np.uint8),
                                 np.zeros((4, 4, 3), np.float32),
                                 np.zeros((0, 4, 3), np.uint8)])
def test_write_png_refuses_other_arrays(tmp_path, bad):
    with pytest.raises(ValueError, match="uint8"):
        write_png(tmp_path / "x.png", bad)
