"""Image files to numpy arrays without Pillow: the port's counterpart of
`Image.open(p).convert("RGB")` (`read_rgb`), of `np.array(Image.open(png))`
(`read_png`), and of `Image.open(p)` in the file's own mode with its
`.convert("RGB")` (`open_image`, `to_rgb`), which CLIP's preprocessing
needs: Pillow resizes before it converts. `write_png` writes the figures
of engine/visualiser.py as 8-bit RGB PNGs.

JPEG decoding and PNG unfiltering run in the native library
(`native/image.cc`), inflate in `zlib`; both give Pillow's pixels bit for
bit (tests/test_torch_image_io.py, tests/test_torch_image_fixtures.py).

Supported:
  JPEG: Huffman-coded, 8-bit; baseline, extended sequential and
    progressive; restart intervals; grayscale, YCbCr (any integral
    sampling; h2v1, h1v2 and h2v2 upsampled as libjpeg-turbo's "fancy"
    filter), RGB (Adobe transform 0) and Adobe CMYK.
  PNG: non-interlaced; bit depth 8 for gray, gray + alpha, RGB, RGBA and
    palette; bit depth 1 for gray (returned as bool, as Pillow's mode "1")
    and palette (returned as indices).
Everything else (arithmetic coding, lossless, 12-bit, YCCK, truncated
streams; Adam7, 16-bit and 2- or 4-bit PNGs; other formats) raises
ValueError naming the file.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Optional, Tuple, Union

import numpy as np

from zutis_tpu_torch.native import image as native_image

PathLike = Union[str, os.PathLike]
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _read(path: PathLike) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _png_chunks(data: bytes, path):
    pos = len(PNG_SIGNATURE)
    while pos < len(data):
        if pos + 8 > len(data):
            raise ValueError(f"{path}: truncated PNG chunk header")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated PNG chunk {ctype!r}")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"{path}: broken PNG chunk {ctype!r} (CRC)")
        yield ctype, body
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG stream (no IEND)")


_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


_PNG_MODES = {0: "L", 2: "RGB", 3: "P", 4: "LA", 6: "RGBA"}


def _decode_png(data: bytes, path):
    """-> (np.array(Image.open(f)), IHDR colour type, bit depth, palette)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for ctype, body in _png_chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) PNG is not supported")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{path}: PNG colour type {ctype} is invalid")
    if depth == 16:
        raise ValueError(f"{path}: 16-bit PNG is not supported")
    if depth != 8 and not (depth == 1 and ctype in (0, 3)):
        raise ValueError(f"{path}: PNG bit depth {depth} with colour type "
                         f"{ctype} is not supported")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without PLTE")
    try:
        native_image.check_pixels(h, w)
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None
    channels = _PNG_CHANNELS[ctype]
    rowbytes = (w * channels * depth + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
        rows = native_image.png_unfilter(raw, h, rowbytes,
                                         channels * depth // 8)
    except (zlib.error, ValueError) as exc:
        raise ValueError(f"{path}: corrupt or truncated PNG data: {exc}") \
            from None
    if depth == 1:
        px = np.unpackbits(rows, axis=1)[:, :w]
        arr = px.astype(bool) if ctype == 0 else px
    elif channels == 1:
        arr = rows
    else:
        arr = rows.reshape(h, w, channels)
    return arr, ctype, depth, palette


def to_rgb(arr: np.ndarray, mode: str, palette=None) -> np.ndarray:
    """Pillow's `.convert("RGB")` of an image of `mode` ("1", "L", "P" with
    its [n, 3] `palette`, "LA", "RGB", "RGBA" or "CMYK") whose pixels are
    `arr`, as `np.asarray` gives them: [H, W, 3] uint8."""
    if mode == "P":
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[arr]
    if mode in ("1", "L"):
        gray = arr.astype(np.uint8) * 255 if mode == "1" else arr
        return np.repeat(gray[..., None], 3, axis=2)
    if mode == "LA":
        return np.repeat(arr[..., :1], 3, axis=2)
    if mode == "CMYK":  # Convert.c's cmyk2rgb: nk - MULDIV255(c, nk)
        nk = 255 - arr[..., 3:].astype(np.int32)
        tmp = arr[..., :3].astype(np.int32) * nk + 128
        return np.clip(nk - (((tmp >> 8) + tmp) >> 8), 0, 255).astype(np.uint8)
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(arr[..., :3])
    raise ValueError(f"no conversion of mode {mode!r} to RGB")


def decode_png(data: bytes, path="<bytes>", rgb: bool = False) -> np.ndarray:
    """A PNG stream -> np.array(Image.open(f)) (rgb=False: uint8 [H, W] for
    gray and palette indices, bool for 1-bit gray, [H, W, C] otherwise) or
    Image.open(f).convert("RGB") (rgb=True)."""
    arr, ctype, depth, palette = _decode_png(data, path)
    if not rgb:
        return arr
    mode = "1" if (ctype, depth) == (0, 1) else _PNG_MODES[ctype]
    return to_rgb(arr, mode, palette)


def _png_chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body)))


def write_png(path: PathLike, rgb: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 array to `path` as an 8-bit RGB PNG (filter
    0 on every row, one IDAT chunk deflated by zlib at its default level)
    that `read_png` and Pillow decode to the same array."""
    arr = np.asarray(rgb)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3 \
            or 0 in arr.shape:
        raise ValueError(f"write_png takes a non-empty [H, W, 3] uint8 array, "
                         f"not {arr.dtype} {arr.shape}")
    h, w = arr.shape[:2]
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # a filter byte before each row
    raw[:, 1:] = arr.reshape(h, 3 * w)
    data = (PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes()))
            + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(data)


def _decode_jpeg(data: bytes, path) -> Tuple[np.ndarray, int]:
    """A JPEG stream -> (its pixels, its component count): [H, W, 3] RGB for
    one or three components, Pillow's "CMYK" samples [H, W, 4] for four."""
    try:
        components = native_image.jpeg_header(data)[2]
        if components == 4:
            return native_image.decode_jpeg_cmyk(data), 4
        return native_image.decode_jpeg_rgb(data), components
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from None


def read_rgb(path: PathLike) -> np.ndarray:
    """`np.asarray(Image.open(path).convert("RGB"))` for a JPEG or PNG
    file: [H, W, 3] uint8."""
    data = _read(path)
    if data[:2] == b"\xff\xd8":
        arr, components = _decode_jpeg(data, path)
        return to_rgb(arr, "CMYK") if components == 4 else arr
    if data.startswith(PNG_SIGNATURE):
        return decode_png(data, path, rgb=True)
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


def open_image(path: PathLike) -> Tuple[np.ndarray, str, Optional[np.ndarray]]:
    """A JPEG or PNG file in Pillow's own mode, before any conversion:
    (`np.asarray(Image.open(path))`, `Image.open(path).mode`, the [n, 3]
    uint8 palette of a "P" image or None). JPEGs open as "L", "RGB" or
    "CMYK"; PNGs as "1", "L", "P", "LA", "RGB" or "RGBA"."""
    data = _read(path)
    if data[:2] == b"\xff\xd8":
        arr, components = _decode_jpeg(data, path)
        if components == 1:
            return np.ascontiguousarray(arr[..., 0]), "L", None
        return arr, ("CMYK" if components == 4 else "RGB"), None
    if data.startswith(PNG_SIGNATURE):
        arr, ctype, depth, palette = _decode_png(data, path)
        if (ctype, depth) == (0, 1):
            return arr, "1", None
        return arr, _PNG_MODES[ctype], palette
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


def read_png(path: PathLike) -> np.ndarray:
    """`np.array(Image.open(path))` for a PNG file."""
    return decode_png(_read(path), path)
