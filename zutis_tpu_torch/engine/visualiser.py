"""Training and evaluation figures as PNG files, composed in numpy (the port
of zutis_tpu/engine/visualiser.py, which draws with matplotlib):

  - semantic triptych: input | ground truth | prediction, the masks
    colourised with a fixed palette (HSV hues shuffled with seed 0);
  - query grid: every query's mask proposal as a viridis heat-map, ten to
    a row;
  - matched pairs: a row for each Hungarian-matched (ground truth,
    proposal) pair, the ground truth in gray and the proposal in viridis;
  - instance overlay: the kept instances alpha-blended over the input in
    distinct colours, with "<label> <score>" at each mask's centroid.

`distinct_colors`, `get_palette`, `colourise_mask` and `denormalise_image`
are the JAX package's, with its float32 arithmetic. The figures hold the
arrays that the JAX functions hand to `imshow`: the heat-maps go through
matplotlib's 256-entry `viridis` and `gray` tables at vmin 0, vmax 1
(`colormaps[name](Normalize(0, 1)(x), bytes=True)`), and every panel keeps
its content's own resolution. Panels stand on a white figure in a grid,
each under its title; text is drawn with a 5 x 7 bitmap font (digits,
lower-case letters, space, "." and "-"; other characters as a box).
Pixels other than the panels' do not follow matplotlib's rendering.

Each figure function returns the composed [H, W, 3] uint8 array and the
labels it drew as (text, x, y) with x the text's left edge and y its
baseline in the array's pixels (the overlay's: the JAX function's text
anchor). The caller writes the array (data/image_io.py::write_png).
"""
from __future__ import annotations

import colorsys
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from zutis_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD

Label = Tuple[str, float, float]

# matplotlib 3.10's colormaps["viridis"] and ["gray"] as bytes=True gives
# them: entry i is the colour of [i / 256, (i + 1) / 256), 1 in the last
VIRIDIS = np.frombuffer(bytes.fromhex(
    "44015444025544035745055845065a45085b46095c460b5e460c5f460e61470f62471163"
    "47126547146647156747166947186a48196b481a6c481c6e481d6f481e70482071482172"
    "482273482374472575472676472777472878472a79472b7a472c7b462d7c462f7c46307d"
    "46317e45327f45347f453580453681443781443982433a83433b83433c84423d84423e85"
    "4240854141864142864043874044873f45873f47883e48883e49893d4a893d4b893d4c89"
    "3c4d8a3c4e8a3b508a3b518a3a528b3a538b39548b39558b38568b38578c37588c37598c"
    "365a8c365b8c355c8c355d8c345e8d345f8d33608d33618d32628d32638d31648d31658d"
    "31668d30678d30688d2f698d2f6a8d2e6b8e2e6c8e2e6d8e2d6e8e2d6f8e2c708e2c718e"
    "2c728e2b738e2b748e2a758e2a768e2a778e29788e29798e287a8e287a8e287b8e277c8e"
    "277d8e277e8e267f8e26808e26818e25828e25838d24848d24858d24868d23878d23888d"
    "23898d22898d228a8d228b8d218c8d218d8c218e8c208f8c20908c20918c1f928c1f938b"
    "1f948b1f958b1f968b1e978a1e988a1e998a1e998a1e9a891e9b891e9c891e9d881e9e88"
    "1e9f881ea0871fa1871fa2861fa38620a48520a58521a68521a78422a78423a88323a982"
    "24aa8225ab8126ac8127ad8028ae7f29af7f2ab07e2bb17d2cb17d2eb27c2fb37b30b47a"
    "32b57a33b67935b77836b87738b97639b9763bba753dbb743ebc7340bd7242be7144be70"
    "45bf6f47c06e49c16d4bc26c4dc26b4fc36951c46853c56755c66657c66559c7645bc862"
    "5ec96160c96062ca5f64cb5d67cc5c69cc5b6bcd596dce5870ce5672cf5574d05477d052"
    "79d1517cd24f7ed24e81d34c83d34b86d44988d5478bd5468dd64490d64392d74195d73f"
    "97d83e9ad83c9dd93a9fd938a2da37a5da35a7db33aadb32addc30afdc2eb2dd2cb5dd2b"
    "b7dd29bade27bdde26bfdf24c2df22c5df21c7e01fcae01ecde01dcfe11cd2e11bd4e11a"
    "d7e219dae218dce218dfe318e1e318e4e318e7e419e9e419ece41aeee51bf1e51cf3e51e"
    "f6e61ff8e621fae622fde724"
), np.uint8).reshape(256, 3)
GRAY = np.frombuffer(bytes.fromhex(
    "0000000101010202020303030404040505050606060707070808080909090a0a0a0b0b0b"
    "0c0c0c0d0d0d0e0e0e0f0f0f101010111111121212131313141414151515161616171717"
    "1818181919191a1a1a1b1b1b1c1c1c1d1d1d1e1e1e1f1f1f202020202020222222232323"
    "2424242424242626262727272828282828282a2a2a2b2b2b2c2c2c2c2c2c2e2e2e2f2f2f"
    "3030303030303232323333333434343434343636363737373838383838383a3a3a3b3b3b"
    "3c3c3c3c3c3c3e3e3e3f3f3f404040414141414141434343444444454545464646474747"
    "4848484949494949494b4b4b4c4c4c4d4d4d4e4e4e4f4f4f505050515151515151535353"
    "5454545555555656565757575858585959595959595b5b5b5c5c5c5d5d5d5e5e5e5f5f5f"
    "6060606161616161616363636464646565656666666767676868686969696969696b6b6b"
    "6c6c6c6d6d6d6e6e6e6f6f6f707070717171717171737373747474757575767676777777"
    "7878787979797979797b7b7b7c7c7c7d7d7d7e7e7e7f7f7f808080818181828282838383"
    "8383838585858686868787878888888989898a8a8a8b8b8b8c8c8c8d8d8d8e8e8e8f8f8f"
    "9090909191919292929393939393939595959696969797979898989999999a9a9a9b9b9b"
    "9c9c9c9d9d9d9e9e9e9f9f9fa0a0a0a1a1a1a2a2a2a3a3a3a3a3a3a5a5a5a6a6a6a7a7a7"
    "a8a8a8a9a9a9aaaaaaabababacacacadadadaeaeaeafafafb0b0b0b1b1b1b2b2b2b3b3b3"
    "b3b3b3b5b5b5b6b6b6b7b7b7b8b8b8b9b9b9babababbbbbbbcbcbcbdbdbdbebebebfbfbf"
    "c0c0c0c1c1c1c2c2c2c3c3c3c3c3c3c5c5c5c6c6c6c7c7c7c8c8c8c9c9c9cacacacbcbcb"
    "cccccccdcdcdcecececfcfcfd0d0d0d1d1d1d2d2d2d3d3d3d3d3d3d5d5d5d6d6d6d7d7d7"
    "d8d8d8d9d9d9dadadadbdbdbdcdcdcdddddddedededfdfdfe0e0e0e1e1e1e2e2e2e3e3e3"
    "e3e3e3e5e5e5e6e6e6e7e7e7e8e8e8e9e9e9eaeaeaebebebecececedededeeeeeeefefef"
    "f0f0f0f1f1f1f2f2f2f3f3f3f3f3f3f5f5f5f6f6f6f7f7f7f8f8f8f9f9f9fafafafbfbfb"
    "fcfcfcfdfdfdfefefeffffff"
), np.uint8).reshape(256, 3)

# 5 x 7 glyphs, a row a number, the leftmost pixel in bit 4
GLYPHS = {
    "a": (0x00, 0x00, 0x0E, 0x01, 0x0F, 0x11, 0x0F),
    "b": (0x10, 0x10, 0x16, 0x19, 0x11, 0x11, 0x1E),
    "c": (0x00, 0x00, 0x0E, 0x10, 0x10, 0x11, 0x0E),
    "d": (0x01, 0x01, 0x0D, 0x13, 0x11, 0x11, 0x0F),
    "e": (0x00, 0x00, 0x0E, 0x11, 0x1F, 0x10, 0x0E),
    "f": (0x06, 0x09, 0x08, 0x1C, 0x08, 0x08, 0x08),
    "g": (0x00, 0x0F, 0x11, 0x11, 0x0F, 0x01, 0x0E),
    "h": (0x10, 0x10, 0x16, 0x19, 0x11, 0x11, 0x11),
    "i": (0x04, 0x00, 0x0C, 0x04, 0x04, 0x04, 0x0E),
    "j": (0x02, 0x00, 0x06, 0x02, 0x02, 0x12, 0x0C),
    "k": (0x10, 0x10, 0x12, 0x14, 0x18, 0x14, 0x12),
    "l": (0x0C, 0x04, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "m": (0x00, 0x00, 0x1A, 0x15, 0x15, 0x11, 0x11),
    "n": (0x00, 0x00, 0x16, 0x19, 0x11, 0x11, 0x11),
    "o": (0x00, 0x00, 0x0E, 0x11, 0x11, 0x11, 0x0E),
    "p": (0x00, 0x00, 0x1E, 0x11, 0x1E, 0x10, 0x10),
    "q": (0x00, 0x00, 0x0D, 0x13, 0x0F, 0x01, 0x01),
    "r": (0x00, 0x00, 0x16, 0x19, 0x10, 0x10, 0x10),
    "s": (0x00, 0x00, 0x0E, 0x10, 0x0E, 0x01, 0x1E),
    "t": (0x08, 0x08, 0x1C, 0x08, 0x08, 0x09, 0x06),
    "u": (0x00, 0x00, 0x11, 0x11, 0x11, 0x13, 0x0D),
    "v": (0x00, 0x00, 0x11, 0x11, 0x11, 0x0A, 0x04),
    "w": (0x00, 0x00, 0x11, 0x11, 0x15, 0x15, 0x0A),
    "x": (0x00, 0x00, 0x11, 0x0A, 0x04, 0x0A, 0x11),
    "y": (0x00, 0x00, 0x11, 0x11, 0x0F, 0x01, 0x0E),
    "z": (0x00, 0x00, 0x1F, 0x02, 0x04, 0x08, 0x1F),
    "0": (0x0E, 0x11, 0x13, 0x15, 0x19, 0x11, 0x0E),
    "1": (0x04, 0x0C, 0x04, 0x04, 0x04, 0x04, 0x0E),
    "2": (0x0E, 0x11, 0x01, 0x02, 0x04, 0x08, 0x1F),
    "3": (0x1F, 0x02, 0x04, 0x02, 0x01, 0x11, 0x0E),
    "4": (0x02, 0x06, 0x0A, 0x12, 0x1F, 0x02, 0x02),
    "5": (0x1F, 0x10, 0x1E, 0x01, 0x01, 0x11, 0x0E),
    "6": (0x06, 0x08, 0x10, 0x1E, 0x11, 0x11, 0x0E),
    "7": (0x1F, 0x01, 0x02, 0x04, 0x08, 0x08, 0x08),
    "8": (0x0E, 0x11, 0x11, 0x0E, 0x11, 0x11, 0x0E),
    "9": (0x0E, 0x11, 0x11, 0x0F, 0x01, 0x02, 0x0C),
    " ": (0x00,) * 7,
    ".": (0x00, 0x00, 0x00, 0x00, 0x00, 0x0C, 0x0C),
    "-": (0x00, 0x00, 0x00, 0x1F, 0x00, 0x00, 0x00),
}
MISSING_GLYPH = (0x1F, 0x11, 0x11, 0x11, 0x11, 0x11, 0x1F)
GLYPH_H, ADVANCE = 7, 6  # a glyph's rows; its columns and one of spacing
MARGIN = 4  # white pixels around and between the panels
TITLE_BAND = GLYPH_H + 4  # a panel's title, 2 pixels above and below
LABEL_PAD = 1  # the overlay label's box around its text
OVERLAY_ALPHA = 0.45


def distinct_colors(n: int) -> List[Tuple[int, int, int]]:
    """n visually-distinct RGB colours (seeded shuffle of HSV hues,
    reference utils/utils.py:312-322)."""
    rng = random.Random(0)
    indices = list(range(n))
    rng.shuffle(indices)
    part = 1.0 / (n + 1)
    out = []
    for v in indices:
        r, g, b = colorsys.hsv_to_rgb(part * v, 1.0, 1.0)
        out.append((int(255 * r), int(255 * g), int(255 * b)))
    return out


def get_palette(n_categories: int) -> Dict[int, Tuple[int, int, int]]:
    """Background black + distinct colours per category."""
    colors = distinct_colors(n_categories - 1)
    palette = {0: (0, 0, 0)}
    for i, c in enumerate(colors, start=1):
        palette[i] = c
    return palette


def colourise_mask(
    mask: np.ndarray,
    palette: Dict[int, Tuple[int, int, int]],
    ignore_index: Optional[int] = None,
) -> np.ndarray:
    """[h, w] label ids -> [h, w, 3] uint8 (ignore_index drawn white,
    reference utils/visualiser.py:38-44)."""
    h, w = mask.shape
    out = np.zeros((h, w, 3), np.uint8)
    for label in np.unique(mask):
        if ignore_index is not None and label == ignore_index:
            out[mask == label] = (255, 255, 255)
        else:
            out[mask == label] = palette[int(label)]
    return out


def denormalise_image(image: np.ndarray) -> np.ndarray:
    """[3, h, w] normalised float -> [h, w, 3] uint8."""
    img = image.transpose(1, 2, 0) * IMAGENET_STD + IMAGENET_MEAN
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def heatmap(x: np.ndarray, table: np.ndarray) -> np.ndarray:
    """[h, w] values -> [h, w, 3] uint8 through a 256-entry table at vmin 0
    and vmax 1, as matplotlib's colormaps map them: entry floor(256 x),
    values below 0 in the first entry, from 1 up in the last, NaN black."""
    x = np.asarray(x)
    if x.dtype.kind != "f":
        x = x.astype(np.float32)
    idx = np.clip(np.nan_to_num(x * 256, nan=0.0), 0, 255).astype(np.int64)
    out = table[idx]
    out[np.isnan(x)] = 0
    return out


def _text_width(text: str) -> int:
    return max(ADVANCE * len(text) - 1, 0)


def text_bitmap(text: str) -> np.ndarray:
    """`text` in the bitmap font: bool [GLYPH_H, ADVANCE * len - 1]."""
    glyphs = [GLYPHS.get(ch, MISSING_GLYPH) for ch in text.lower()]
    bitmap = np.zeros((GLYPH_H, _text_width(text)), bool)
    for i, glyph in enumerate(glyphs):
        for r, row in enumerate(glyph):
            for k in range(5):
                bitmap[r, ADVANCE * i + k] = (row >> (4 - k)) & 1
    return bitmap


def _clipped(canvas: np.ndarray, y0: int, x0: int, h: int, w: int):
    """The part of the box [y0, y0 + h) x [x0, x0 + w) inside `canvas`:
    (its slices in the canvas, its slices in the box), or None."""
    H, W = canvas.shape[:2]
    ya, yb, xa, xb = max(y0, 0), min(y0 + h, H), max(x0, 0), min(x0 + w, W)
    if ya >= yb or xa >= xb:
        return None
    return ((slice(ya, yb), slice(xa, xb)),
            (slice(ya - y0, yb - y0), slice(xa - x0, xb - x0)))


def draw_text(canvas: np.ndarray, text: str, x: int, y: int,
              colour: Tuple[int, int, int]) -> None:
    """`text` into `canvas` in place, its left edge at column x and its
    bottom row at y - 1; what falls outside the canvas is cut off."""
    bitmap = text_bitmap(text)
    part = _clipped(canvas, y - GLYPH_H, x, *bitmap.shape)
    if part is not None:
        canvas[part[0]][bitmap[part[1]]] = colour


def label_box(text: str, x: int, y: int) -> Tuple[int, int, int, int]:
    """(y0, y1, x0, x1): the pixels an overlay label at (x, y) covers,
    before clipping to the image."""
    return (y - GLYPH_H - LABEL_PAD, y + LABEL_PAD,
            x - LABEL_PAD, x + _text_width(text) + LABEL_PAD)


def layout(cells: Sequence[Optional[Tuple[str, int, int]]], n_cols: int
           ) -> Tuple[Tuple[int, int], List[Optional[Tuple[int, int]]]]:
    """Where `compose` puts panels of these (title, h, w), or None for an
    empty cell: ((figure h, figure w), each panel's top-left (y, x)). The
    cells stand in rows of `n_cols`, each as tall as the tallest panel and
    as wide as the widest panel or title, under a band for the titles."""
    drawn = [c for c in cells if c is not None]
    ph = max((h for _, h, _ in drawn), default=0)
    pw = max((max(w, _text_width(title)) for title, _, w in drawn), default=0)
    n_rows = (len(cells) + n_cols - 1) // n_cols
    cell_h, cell_w = TITLE_BAND + ph + MARGIN, pw + MARGIN
    origins = [None if c is None else
               (MARGIN + (i // n_cols) * cell_h + TITLE_BAND,
                MARGIN + (i % n_cols) * cell_w) for i, c in enumerate(cells)]
    return (MARGIN + n_rows * cell_h, MARGIN + n_cols * cell_w), origins


def compose(panels: Sequence[Optional[Tuple[str, np.ndarray]]],
            n_cols: int) -> Tuple[np.ndarray, List[Label]]:
    """(title, [h, w, 3] uint8) panels, or None for an empty cell, on a
    white figure as `layout` places them, each title centred over its
    panel where the panel is wider."""
    (fh, fw), origins = layout(
        [None if p is None else (p[0], *p[1].shape[:2]) for p in panels],
        n_cols)
    canvas = np.full((fh, fw, 3), 255, np.uint8)
    labels: List[Label] = []
    for panel, origin in zip(panels, origins):
        if panel is None:
            continue
        (title, img), (y0, x0) = panel, origin
        h, w = img.shape[:2]
        canvas[y0:y0 + h, x0:x0 + w] = img
        tx = x0 + max((w - _text_width(title)) // 2, 0)
        draw_text(canvas, title, tx, y0 - 2, (0, 0, 0))
        labels.append((title, tx, y0 - 2))
    return canvas, labels


def semantic_triptych(
    image: np.ndarray,  # [3, h, w] normalised
    ground_truth: np.ndarray,  # [h, w]
    prediction: np.ndarray,  # [h, w]
    palette: Dict[int, Tuple[int, int, int]],
    ignore_index: Optional[int] = None,
) -> Tuple[np.ndarray, List[Label]]:
    """Input, ground truth and prediction side by side."""
    return compose([
        ("input", denormalise_image(image)),
        ("ground truth", colourise_mask(ground_truth, palette, ignore_index)),
        ("prediction", colourise_mask(prediction, palette, ignore_index)),
    ], 3)


def query_grid(
    mask_proposals: np.ndarray,  # [Q, h, w] in [0, 1]
    n_cols: int = 10,
) -> Tuple[np.ndarray, List[Label]]:
    """Every query's proposal heat-map, titled with its index, `n_cols` to a
    row (reference utils/visualiser.py:189-208)."""
    q = mask_proposals.shape[0]
    n_cells = (q + n_cols - 1) // n_cols * n_cols
    return compose(
        [(str(i), heatmap(mask_proposals[i], VIRIDIS)) if i < q else None
         for i in range(n_cells)], n_cols)


def matched_pairs(
    instance_masks: np.ndarray,  # [N, h, w] ground-truth binaries
    mask_proposals: np.ndarray,  # [Q, h, w] proposals
    assignment: Sequence[int],  # proposal index per ground-truth row
) -> Optional[Tuple[np.ndarray, List[Label]]]:
    """A row for each Hungarian-matched (gt, proposal) pair (reference
    utils/visualiser.py:210-236); with no rows, nothing (None)."""
    if len(assignment) == 0:
        return None
    panels = []
    for row, qi in enumerate(assignment):
        panels += [(f"gt {row}", heatmap(instance_masks[row], GRAY)),
                   (f"query {qi}", heatmap(mask_proposals[qi], VIRIDIS))]
    return compose(panels, 2)


def instance_overlay(
    image: np.ndarray,  # [3, h, w] normalised
    masks: np.ndarray,  # [K, H, W] bool (kept instances)
    scores: Sequence[float],
    labels: Sequence[str],
    alpha: float = OVERLAY_ALPHA,
) -> Tuple[np.ndarray, List[Label]]:
    """Kept instances alpha-blended with per-instance colours + score text —
    a self-contained replacement for the reference's detectron2 overlay
    (utils/visualiser.py:154-187). The image is the JAX function's canvas;
    each label stands in a box of half-transparent black, its text white."""
    base = denormalise_image(image).astype(np.float32)
    H, W = base.shape[:2]
    k = masks.shape[0]
    colors = distinct_colors(max(k, 1))
    canvas = base.copy()
    for i in range(k):
        m = masks[i]
        if m.shape != (H, W):
            continue
        col = np.array(colors[i], np.float32)
        canvas[m] = (1 - alpha) * canvas[m] + alpha * col
    canvas = canvas.astype(np.uint8)
    drawn: List[Label] = []
    for i in range(k):
        ys, xs = np.nonzero(masks[i])
        if ys.size == 0:
            continue
        text, x, y = (f"{labels[i]} {scores[i]:.2f}", float(xs.mean()),
                      float(ys.mean()))
        px, py = int(round(x)), int(round(y))
        y0, y1, x0, x1 = label_box(text, px, py)
        part = _clipped(canvas, y0, x0, y1 - y0, x1 - x0)
        if part is not None:
            box = canvas[part[0]]
            canvas[part[0]] = (box.astype(np.float32) * 0.5).astype(np.uint8)
        draw_text(canvas, text, px, py, (255, 255, 255))
        drawn.append((text, x, y))
    return canvas, drawn
