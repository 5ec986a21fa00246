"""Write the decoder's fixture images and their Pillow decodes' hashes.

    python tests/torch_fixtures/make_fixtures.py

Needs Pillow. Writes seeded synthetic JPEGs (4:2:0, 4:2:2, 4:4:4,
grayscale, Adobe CMYK, progressive, optimised Huffman tables, restart
markers, odd sizes; five 500 x 375 "photos" for the smoke's fixture
dataset) and one PNG per supported mode into this directory, and
`expected.json`: each file's shape, dtype and the SHA-256 of Pillow's
decode (`Image.open(p).convert("RGB")` for a JPEG, `np.array(Image.open(p))`
for a PNG). tests/test_torch_image_io.py checks that Pillow still gives
those hashes; tests/test_torch_image_fixtures.py and chip_smoke.py hold the
port's decoder to them.
"""
import hashlib
import json
from pathlib import Path

import numpy as np
from PIL import Image

HERE = Path(__file__).resolve().parent


def photo(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """A smooth picture with a few soft-edged blobs and mild noise."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    img = np.zeros((h, w, 3), np.float32)
    for c in range(3):
        a, b, p = rng.uniform(-1, 1, 3)
        img[..., c] = 128 + 60 * np.sin(a * xx / 40 + b * yy / 50 + 6 * p)
    for _ in range(rng.integers(3, 7)):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        ry, rx = rng.uniform(0.1, 0.4) * h, rng.uniform(0.1, 0.4) * w
        d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
        alpha = 1 / (1 + np.exp(np.minimum(8 * (d - 1), 50)))
        img = img * (1 - alpha[..., None]) + alpha[..., None] * rng.uniform(
            0, 255, 3)
    # texture at several scales, so the entropy-coded data is photo-like
    for scale in (2, 5):
        fine = rng.normal(0, 7, (h // scale + 1, w // scale + 1, 3))
        img += np.repeat(np.repeat(fine, scale, 0), scale, 1)[:h, :w]
    img += rng.normal(0, 3, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


JPEGS = [
    # name, (h, w), mode, save kwargs
    ("photo_0_420_q75.jpg", (375, 500), "RGB", dict(quality=75, subsampling=2)),
    ("photo_1_420_q75.jpg", (375, 500), "RGB", dict(quality=75, subsampling=2)),
    ("photo_2_420_q75.jpg", (375, 500), "RGB", dict(quality=75, subsampling=2)),
    ("photo_3_420_q75.jpg", (375, 500), "RGB", dict(quality=75, subsampling=2)),
    ("photo_4_420_q75.jpg", (375, 500), "RGB", dict(quality=75, subsampling=2)),
    ("largest_640x480_422_q80_progressive.jpg", (480, 640), "RGB",
     dict(quality=80, subsampling=1, progressive=True)),
    ("rgb_422_q90_33x17.jpg", (17, 33), "RGB", dict(quality=90, subsampling=1)),
    ("rgb_444_q95_7x5.jpg", (5, 7), "RGB", dict(quality=95, subsampling=0)),
    ("rgb_420_q30_1x1.jpg", (1, 1), "RGB", dict(quality=30, subsampling=2)),
    ("rgb_420_q80_progressive_257x191.jpg", (191, 257), "RGB",
     dict(quality=80, subsampling=2, progressive=True)),
    ("rgb_420_q75_restart_97x61.jpg", (61, 97), "RGB",
     dict(quality=75, subsampling=2, restart_marker_blocks=3)),
    ("rgb_422_q85_progressive_restart_65x49.jpg", (49, 65), "RGB",
     dict(quality=85, subsampling=1, progressive=True, restart_marker_rows=1)),
    ("rgb_420_q60_optimize_129x77.jpg", (77, 129), "RGB",
     dict(quality=60, subsampling=2, optimize=True)),
    ("gray_q75_33x17.jpg", (33, 17), "L", dict(quality=75)),
    ("gray_q90_progressive_100x75.jpg", (75, 100), "L",
     dict(quality=90, progressive=True)),
    ("cmyk_q90_40x24.jpg", (24, 40), "CMYK", dict(quality=90)),
]

PNGS = [
    # name, (h, w), Pillow mode
    ("gray8_37x21.png", (21, 37), "L"),
    ("gray1_45x19.png", (19, 45), "1"),
    ("gray_alpha_23x16.png", (16, 23), "LA"),
    ("rgb_31x27.png", (27, 31), "RGB"),
    ("rgba_18x29.png", (29, 18), "RGBA"),
    ("palette8_33x20.png", (20, 33), "P"),
    ("palette1_26x11.png", (11, 26), "P1"),
]


def decode(path: Path) -> np.ndarray:
    with Image.open(path) as im:
        if path.suffix == ".png":
            return np.array(im)
        return np.asarray(im.convert("RGB"))


def record(path: Path) -> dict:
    arr = np.ascontiguousarray(decode(path))
    return {"shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256": hashlib.sha256(arr.tobytes()).hexdigest(),
            "bytes": path.stat().st_size}


def main() -> None:
    rng = np.random.default_rng(20261017)
    expected = {}
    for name, (h, w), mode, kw in JPEGS:
        px = photo(rng, h, w)
        if mode == "L":
            im = Image.fromarray(px).convert("L")
        elif mode == "CMYK":
            im = Image.fromarray(px).convert("CMYK")
        else:
            im = Image.fromarray(px)
        im.save(HERE / name, "JPEG", **kw)
        expected[name] = record(HERE / name)
    for name, (h, w), mode in PNGS:
        px = photo(rng, h, w)
        if mode == "1":
            im = Image.fromarray(px).convert("L").point(
                lambda v: 255 if v > 128 else 0).convert("1")
        elif mode in ("P", "P1"):
            colors = 2 if mode == "P1" else 40
            im = Image.fromarray(px).quantize(colors)
        elif mode in ("LA", "RGBA"):
            alpha = rng.integers(0, 256, (h, w), dtype=np.uint8)
            base = Image.fromarray(px).convert(mode[:-1])
            base.putalpha(Image.fromarray(alpha))
            im = base
        else:
            im = Image.fromarray(px).convert(mode)
        im.save(HERE / name, "PNG", **({"bits": 1} if mode == "P1" else {}))
        expected[name] = record(HERE / name)
    with open(HERE / "expected.json", "w") as f:
        json.dump(expected, f, indent=1, sort_keys=True)
    total = sum(r["bytes"] for r in expected.values())
    print(f"{len(expected)} files, {total} bytes")


if __name__ == "__main__":
    main()
