"""The host image library (native/image.cc), bound with ctypes: JPEG
decoding (to RGB, or to Pillow's "CMYK" mode), PNG unfiltering, cv2's
Gaussian blur and Pillow's hue round trip.

Built with g++ at first use by `ops/_build.py` (into `build/zutis_tpu_torch/`,
keyed by the source and the flags, renamed into place), exactly as the RLE
codec beside it. ctypes releases the GIL during each call, so the loader's
threads decode in parallel. A missing g++ or a failed build raises; there
is no fallback. `data/image_io.py` and `data/augment.py` wrap these calls.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np

from zutis_tpu_torch.ops import _build

SOURCE = Path(__file__).resolve().parent / "image.cc"
STEM = "libimage"
ERR_CAP = 256
# Pillow's DecompressionBombError threshold: 2 * Image.MAX_IMAGE_PIXELS
MAX_PIXELS = 2 * (1024 * 1024 * 1024 // 4 // 3)

_u8_p = ctypes.POINTER(ctypes.c_uint8)


def build():
    """Compile the library if needed; see `_build.build`."""
    return _build.build(SOURCE, STEM)


def _bind(lib: ctypes.CDLL) -> None:
    lib.jpeg_header.restype = ctypes.c_int
    lib.jpeg_header.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p,
                                ctypes.c_int]
    for name in ("jpeg_decode_rgb", "jpeg_decode_cmyk"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, _u8_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_char_p, ctypes.c_int]
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                 ctypes.c_int64, ctypes.c_int, _u8_p,
                                 ctypes.c_char_p, ctypes.c_int]
    lib.gaussian_blur_u8.restype = ctypes.c_int
    lib.gaussian_blur_u8.argtypes = [_u8_p, _u8_p, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int,
                                     ctypes.c_double]
    lib.rgb_hue_shift.restype = None
    lib.rgb_hue_shift.argtypes = [_u8_p, ctypes.c_int64, ctypes.c_int]


def load_image_lib() -> ctypes.CDLL:
    """The library, built on first use and loaded once per process."""
    return _build.load(SOURCE, STEM, _bind)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u8_p)


def check_pixels(h: int, w: int) -> None:
    """Refuse an image larger than Pillow opens (a decompression bomb)."""
    if h * w > MAX_PIXELS:
        raise ValueError(f"image of {h} x {w} pixels exceeds the limit of "
                         f"{MAX_PIXELS} (as Pillow refuses it)")


def jpeg_header(data: bytes) -> tuple:
    """A JPEG stream's (height, width, components); raises ValueError on
    headers it does not decode."""
    err = ctypes.create_string_buffer(ERR_CAP)
    dims = (ctypes.c_int * 3)()
    if load_image_lib().jpeg_header(data, len(data), dims, err,
                                    ERR_CAP) != 0:
        raise ValueError(err.value.decode())
    return dims[0], dims[1], dims[2]


def _decode_jpeg(data: bytes, channels: int, entry: str) -> np.ndarray:
    h, w, _ = jpeg_header(data)
    check_pixels(h, w)
    out = np.empty((h, w, channels), np.uint8)
    err = ctypes.create_string_buffer(ERR_CAP)
    if getattr(load_image_lib(), entry)(data, len(data), _ptr(out), h, w,
                                        err, ERR_CAP) != 0:
        raise ValueError(err.value.decode())
    return out


def decode_jpeg_rgb(data: bytes) -> np.ndarray:
    """A one- or three-component JPEG stream -> [H, W, 3] uint8 RGB,
    Pillow's `Image.open(f).convert("RGB")`; raises ValueError on a stream
    it does not decode (the message says why), a CMYK one included."""
    return _decode_jpeg(data, 3, "jpeg_decode_rgb")


def decode_jpeg_cmyk(data: bytes) -> np.ndarray:
    """A four-component JPEG stream -> [H, W, 4] uint8, the pixels of
    Pillow's "CMYK" mode (`np.asarray(Image.open(f))`: the inverted
    samples, as Pillow reads Adobe's convention)."""
    return _decode_jpeg(data, 4, "jpeg_decode_cmyk")


def png_unfilter(raw: bytes, h: int, rowbytes: int, bpp: int) -> np.ndarray:
    """Inflated PNG scanlines (a filter byte, then `rowbytes` bytes, per
    row) -> the [h, rowbytes] unfiltered bytes; raises ValueError on an
    unknown filter type."""
    if len(raw) != h * (rowbytes + 1):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not "
                         f"{h * (rowbytes + 1)}")
    lib = load_image_lib()
    out = np.empty((h, rowbytes), np.uint8)
    err = ctypes.create_string_buffer(ERR_CAP)
    if lib.png_unfilter(raw, h, rowbytes, max(1, bpp), _ptr(out), err,
                        ERR_CAP) != 0:
        raise ValueError(err.value.decode())
    return out


def gaussian_blur(image: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(image, (ksize, ksize), sigma) on an [H, W] or
    [H, W, C] uint8 image (BORDER_REFLECT_101), bit for bit."""
    src = np.ascontiguousarray(image, np.uint8)
    h, w = src.shape[:2]
    cn = 1 if src.ndim == 2 else src.shape[2]
    dst = np.empty_like(src)
    if load_image_lib().gaussian_blur_u8(_ptr(src), _ptr(dst), h, w, cn,
                                         int(ksize), float(sigma)) != 0:
        raise ValueError(f"gaussian_blur: ksize {ksize} must be odd and "
                         f"positive, sigma {sigma} positive, the image "
                         f"non-empty")
    return dst


def hue_shift(rgb: np.ndarray, shift: int) -> np.ndarray:
    """Pillow's `im.convert("HSV")`, hue + `shift` mod 256, then
    `.convert("RGB")`, on an [H, W, 3] uint8 image (a new array)."""
    out = np.array(rgb, np.uint8, order="C", copy=True)
    if out.ndim != 3 or out.shape[2] != 3:
        raise ValueError(f"hue_shift takes [H, W, 3] uint8, got {out.shape}")
    load_image_lib().rgb_hue_shift(_ptr(out), out.shape[0] * out.shape[1],
                                   int(shift))
    return out
