"""The port's JPEG and PNG decoder (data/image_io.py on native/image.cc)
against Pillow, bit for bit: `read_rgb` against
`np.asarray(Image.open(p).convert("RGB"))` and `read_png` against
`np.array(Image.open(p))`, over a matrix of sizes, subsamplings (4:1:1 and
4:4:0 written by OpenCV),
qualities, grayscale and CMYK, progressive, optimised and restart-marker
JPEGs, PNGs of every supported mode (and hand-written ones whose rows use
each of the five filters), and the refusals, each naming the file. Also
checks that Pillow still gives the hashes pinned in
tests/torch_fixtures/expected.json."""
import hashlib
import io
import json
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from zutis_tpu_torch.data.image_io import decode_png, read_png, read_rgb
from zutis_tpu_torch.native import image as native_image

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
SIZES = [(1, 1), (5, 7), (33, 17), (375, 500)]  # (h, w): 1x1, 7x5, 17x33, 500x375
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


def picture(h, w, channels, seed):
    """Smooth colour fields plus noise: blocks with DC and AC content."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(xx / (3 + 5 * c) + yy / (4 + 3 * c) + c)
                    for c in range(channels)], -1)
    img = img + rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def jpeg_bytes(arr, mode="RGB", **kw):
    im = Image.fromarray(arr if arr.shape[-1] != 1 else arr[..., 0])
    if mode != im.mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, "JPEG", **kw)
    return buf.getvalue()


def check_jpeg(tmp_path, data, name="x.jpg"):
    path = tmp_path / name
    path.write_bytes(data)
    with Image.open(path) as im:
        want = np.asarray(im.convert("RGB"))
    got = read_rgb(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("quality", [30, 75, 95])
@pytest.mark.parametrize("sub", sorted(SUBSAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_baseline_ycbcr_equals_pillow(tmp_path, size, sub, quality):
    arr = picture(*size, 3, seed=quality)
    check_jpeg(tmp_path, jpeg_bytes(arr, quality=quality,
                                    subsampling=SUBSAMPLING[sub]))


VARIANTS = {
    "progressive": dict(progressive=True),
    "optimize": dict(optimize=True),
    "restart_blocks": dict(restart_marker_blocks=1),
    "restart_rows": dict(restart_marker_rows=1),
    "progressive_restart": dict(progressive=True, restart_marker_blocks=2),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("sub", sorted(SUBSAMPLING))
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_progressive_optimized_and_restart_equal_pillow(tmp_path, size, sub,
                                                         variant):
    arr = picture(*size, 3, seed=len(variant))
    check_jpeg(tmp_path, jpeg_bytes(arr, quality=85,
                                    subsampling=SUBSAMPLING[sub],
                                    **VARIANTS[variant]))


@pytest.mark.parametrize("mode", ["L", "CMYK"])
@pytest.mark.parametrize("quality", [30, 75, 95])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"{s[1]}x{s[0]}")
def test_gray_and_cmyk_equal_pillow(tmp_path, size, quality, mode):
    arr = picture(*size, 3, seed=7)
    check_jpeg(tmp_path, jpeg_bytes(arr, mode, quality=quality))


@pytest.mark.parametrize("mode", ["L", "CMYK"])
def test_progressive_gray_and_cmyk_equal_pillow(tmp_path, mode):
    arr = picture(61, 83, 3, seed=3)
    check_jpeg(tmp_path, jpeg_bytes(arr, mode, quality=80, progressive=True))


def test_odd_sizes_of_every_subsampling_equal_pillow(tmp_path):
    for h in (1, 2, 3, 8, 9, 15, 16, 17):
        for w in (1, 2, 3, 15, 16, 17, 31):
            for sub in SUBSAMPLING.values():
                data = jpeg_bytes(picture(h, w, 3, seed=h * w), quality=90,
                                  subsampling=sub)
                check_jpeg(tmp_path, data)


CV2_SAMPLING = ["411", "420", "422", "440", "444"]


@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("sampling", CV2_SAMPLING)
@pytest.mark.parametrize("size", SIZES + [(2, 2), (3, 3)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
def test_opencv_written_sampling_factors_equal_pillow(tmp_path, size,
                                                      sampling, progressive):
    """4:1:1 (h4v1, replicated) and 4:4:0 (h1v2, fancy) come from OpenCV's
    writer; Pillow's cannot write them."""
    import cv2

    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    ok, buf = cv2.imencode(".jpg", picture(*size, 3, seed=11), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor,
        cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_PROGRESSIVE,
        progressive])
    assert ok
    check_jpeg(tmp_path, buf.tobytes())


# ------------------------------------------------------------ refusals

def _patched(data: bytes, old: bytes, new: bytes) -> bytes:
    assert old in data
    return data.replace(old, new, 1)


def _sof_at(data: bytes) -> int:
    for marker in (b"\xff\xc0", b"\xff\xc1", b"\xff\xc2"):
        pos = data.find(marker)
        if pos >= 0:
            return pos
    raise AssertionError("no SOF")


def _with_sof(data: bytes, code: int) -> bytes:
    pos = _sof_at(data)
    return data[:pos + 1] + bytes([code]) + data[pos + 2:]


REFUSALS = {
    "arithmetic": (lambda d: _with_sof(d, 0xC9), "arithmetic"),
    "lossless": (lambda d: _with_sof(d, 0xC3), "lossless"),
    "hierarchical": (lambda d: _with_sof(d, 0xC5), "hierarchical"),
    "12-bit": (lambda d: d[:_sof_at(d) + 4] + b"\x0c" + d[_sof_at(d) + 5:],
               "12-bit"),
    "truncated": (lambda d: d[:len(d) * 2 // 3], "truncated"),
    "no EOI": (lambda d: d[:-2], "truncated"),
    "no SOI": (lambda d: d[2:], "neither a JPEG nor a PNG"),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_unsupported_jpegs_raise_naming_the_file(tmp_path, case):
    edit, message = REFUSALS[case]
    path = tmp_path / f"bad_{case.replace(' ', '_')}.jpg"
    path.write_bytes(edit(jpeg_bytes(picture(40, 56, 3, seed=1), quality=80)))
    with pytest.raises(ValueError, match=f"{path.name}.*{message}"):
        read_rgb(path)


def test_ycck_raises_naming_the_file(tmp_path):
    data = jpeg_bytes(picture(24, 32, 3, seed=2), "CMYK", quality=90)
    pos = data.find(b"Adobe")
    assert pos > 0 and data[pos + 11] == 0  # Pillow writes transform 0
    path = tmp_path / "ycck.jpg"
    path.write_bytes(data[:pos + 11] + b"\x02" + data[pos + 12:])
    with pytest.raises(ValueError, match="ycck.jpg.*YCCK"):
        read_rgb(path)


# ------------------------------------------------------------------ PNG

PNG_MODES = ["L", "1", "LA", "RGB", "RGBA", "P", "P1"]


def pillow_png(arr_rgb, mode, seed):
    im = Image.fromarray(arr_rgb)
    if mode == "1":
        return im.convert("L").convert("1"), {}
    if mode in ("P", "P1"):
        return im.quantize(2 if mode == "P1" else 64), (
            {"bits": 1} if mode == "P1" else {})
    if mode in ("LA", "RGBA"):
        base = im.convert(mode[:-1])
        rng = np.random.default_rng(seed)
        base.putalpha(Image.fromarray(
            rng.integers(0, 256, arr_rgb.shape[:2], dtype=np.uint8)))
        return base, {}
    return im.convert(mode), {}


@pytest.mark.parametrize("mode", PNG_MODES)
@pytest.mark.parametrize("size", [(1, 1), (5, 7), (33, 17), (64, 90)],
                         ids=lambda s: f"{s[1]}x{s[0]}")
def test_png_modes_equal_pillow(tmp_path, size, mode):
    im, kw = pillow_png(picture(*size, 3, seed=5), mode, seed=6)
    path = tmp_path / "x.png"
    im.save(path, "PNG", **kw)
    with Image.open(path) as ref:
        want = np.array(ref)
        want_rgb = np.asarray(ref.convert("RGB"))
    got = read_png(path)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(read_rgb(path), want_rgb)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _filter_row(f, row, prev, bpp):
    out = bytearray(len(row))
    for i, x in enumerate(row):
        a = row[i - bpp] if i >= bpp else 0
        b = prev[i] if prev is not None else 0
        c = prev[i - bpp] if prev is not None and i >= bpp else 0
        if f == 0:
            pred = 0
        elif f == 1:
            pred = a
        elif f == 2:
            pred = b
        elif f == 3:
            pred = (a + b) >> 1
        else:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[i] = (x - pred) & 255
    return bytes([f]) + bytes(out)


def handmade_png(rows: np.ndarray, ctype: int, filters, depth=8,
                 interlace=0, plte=None) -> bytes:
    h = rows.shape[0]
    w = rows.shape[1] if depth == 8 else rows.shape[1] * 8
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    flat = rows.reshape(h, -1)
    bpp = max(1, channels * depth // 8)
    raw = b"".join(
        _filter_row(filters[y % len(filters)], flat[y].tobytes(),
                    flat[y - 1].tobytes() if y else None, bpp)
        for y in range(h))
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0,
                                       interlace))
    if plte is not None:
        body += _chunk(b"PLTE", plte)
    return (b"\x89PNG\r\n\x1a\n" + body
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


FILTER_SETS = {"none": [0], "sub": [1], "up": [2], "average": [3],
               "paeth": [4], "mixed": [0, 1, 2, 3, 4]}
COLOUR_TYPES = {"gray": (0, 1), "rgb": (2, 3), "gray_alpha": (4, 2),
                "rgba": (6, 4)}


@pytest.mark.parametrize("ctype", sorted(COLOUR_TYPES))
@pytest.mark.parametrize("filters", sorted(FILTER_SETS))
def test_handmade_png_filters_equal_pillow(ctype, filters):
    code, channels = COLOUR_TYPES[ctype]
    rng = np.random.default_rng(len(ctype) + len(filters))
    rows = rng.integers(0, 256, (9, 13, channels), dtype=np.uint8)
    data = handmade_png(rows, code, FILTER_SETS[filters])
    with Image.open(io.BytesIO(data)) as ref:
        want = np.array(ref)
    np.testing.assert_array_equal(decode_png(data), want)


def test_handmade_palette_and_1bit_pngs_equal_pillow():
    rng = np.random.default_rng(9)
    idx = rng.integers(0, 5, (7, 11), dtype=np.uint8)
    plte = rng.integers(0, 256, (5, 3), dtype=np.uint8).tobytes()
    data = handmade_png(idx, 3, [0, 1, 2, 3, 4], plte=plte)
    with Image.open(io.BytesIO(data)) as ref:
        np.testing.assert_array_equal(decode_png(data), np.array(ref))
        np.testing.assert_array_equal(decode_png(data, rgb=True),
                                      np.asarray(ref.convert("RGB")))
    bits = rng.integers(0, 256, (6, 3), dtype=np.uint8)  # 24 px a row
    data = handmade_png(bits, 0, [0, 2, 4], depth=1)
    with Image.open(io.BytesIO(data)) as ref:
        want = np.array(ref)
    assert want.dtype == bool
    np.testing.assert_array_equal(decode_png(data), want)


def test_decompression_bombs_raise_as_pillow_refuses_them(tmp_path):
    data = jpeg_bytes(picture(8, 8, 3, seed=0), quality=80)
    pos = _sof_at(data)
    huge = data[:pos + 5] + struct.pack(">HH", 20000, 20000) + data[pos + 9:]
    path = tmp_path / "bomb.jpg"
    path.write_bytes(huge)
    with pytest.raises(Image.DecompressionBombError):
        Image.open(path).load()
    with pytest.raises(ValueError, match="bomb.jpg.*exceeds the limit"):
        read_rgb(path)
    path = tmp_path / "bomb.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", 20000, 20000, 8, 0, 0, 0, 0))
        + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="bomb.png.*exceeds the limit"):
        read_png(path)


PNG_REFUSALS = {
    "adam7": (dict(interlace=1), "interlaced"),
    "16-bit": (dict(depth=16), "16-bit"),
    "4-bit": (dict(depth=4), "bit depth 4"),
}


@pytest.mark.parametrize("case", sorted(PNG_REFUSALS))
def test_unsupported_pngs_raise_naming_the_file(tmp_path, case):
    kw, message = PNG_REFUSALS[case]
    rows = np.zeros((4, 4), np.uint8)
    data = handmade_png(rows, 0, [0], **kw)
    path = tmp_path / f"bad_{case}.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match=f"bad_{case}.png.*{message}"):
        read_png(path)


@pytest.mark.parametrize("case", ["crc", "truncated", "filter type"])
def test_corrupt_pngs_raise_naming_the_file(tmp_path, case):
    data = handmade_png(np.arange(48, dtype=np.uint8).reshape(4, 12), 0, [1])
    if case == "crc":
        pos = data.find(b"IDAT") + 6
        data = data[:pos] + bytes([data[pos] ^ 1]) + data[pos + 1:]
    elif case == "truncated":
        data = data[:len(data) - 20]
    else:
        body = zlib.compress(b"\x07" + bytes(12) + b"\x00" + bytes(12))
        data = handmade_png(np.zeros((2, 12), np.uint8), 0, [0])
        start = data.find(b"IDAT") - 4
        end = data.find(b"IEND") - 4
        data = data[:start] + _chunk(b"IDAT", body) + data[end:]
    path = tmp_path / "corrupt.png"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="corrupt.png"):
        read_png(path)


# ------------------------------------------------------------ fixtures

EXPECTED = json.loads((FIXTURES / "expected.json").read_text())


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_pillow_still_gives_the_pinned_hashes(name):
    path = FIXTURES / name
    with Image.open(path) as im:
        arr = np.array(im) if path.suffix == ".png" else np.asarray(
            im.convert("RGB"))
    arr = np.ascontiguousarray(arr)
    assert list(arr.shape) == EXPECTED[name]["shape"]
    assert str(arr.dtype) == EXPECTED[name]["dtype"]
    assert hashlib.sha256(arr.tobytes()).hexdigest() == \
        EXPECTED[name]["sha256"]


def test_native_entry_points_refuse_bad_arguments():
    with pytest.raises(ValueError, match="not a JPEG"):
        native_image.decode_jpeg_rgb(b"\x00\x01")
    with pytest.raises(ValueError, match="holds"):
        native_image.png_unfilter(b"\x00" * 3, 2, 4, 1)
    with pytest.raises(ValueError):
        native_image.gaussian_blur(np.zeros((4, 4, 3), np.uint8), 4, 1.0)
