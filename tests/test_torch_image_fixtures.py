"""The port's image decoder against Pillow's pinned decodes of the committed
fixture images (tests/torch_fixtures/expected.json: shape, dtype and the
SHA-256 of `Image.open(p).convert("RGB")` for each JPEG and of
`np.array(Image.open(p))` for each PNG). Imports neither JAX nor Pillow, so
that it runs where neither exists:

    python -m pytest --noconftest tests/test_torch_image_fixtures.py

(tests/test_torch_image_io.py checks that Pillow still gives those hashes.)
"""
import hashlib
import json
from pathlib import Path

import numpy as np
import pytest

from zutis_tpu_torch.data.image_io import read_png, read_rgb

FIXTURES = Path(__file__).resolve().parent / "torch_fixtures"
EXPECTED = json.loads((FIXTURES / "expected.json").read_text())


def decode(name: str) -> np.ndarray:
    path = FIXTURES / name
    return read_png(path) if path.suffix == ".png" else read_rgb(path)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_decode_equals_pillows_pinned_hash(name):
    arr = np.ascontiguousarray(decode(name))
    want = EXPECTED[name]
    assert list(arr.shape) == want["shape"]
    assert str(arr.dtype) == want["dtype"]
    assert hashlib.sha256(arr.tobytes()).hexdigest() == want["sha256"]


def test_fixtures_cover_every_supported_kind():
    names = " ".join(EXPECTED)
    for kind in ("420", "422", "444", "gray", "cmyk", "progressive",
                 "restart", "optimize", "gray8", "gray1", "gray_alpha",
                 "rgb_", "rgba", "palette8", "palette1"):
        assert kind in names, kind
    assert any(r["shape"][:2] == [375, 500] for r in EXPECTED.values())
    assert sum(r["bytes"] for r in EXPECTED.values()) <= 300_000


def test_a_truncated_fixture_raises_naming_the_file(tmp_path):
    data = (FIXTURES / "photo_0_420_q75.jpg").read_bytes()
    cut = tmp_path / "cut.jpg"
    cut.write_bytes(data[:len(data) // 2])
    with pytest.raises(ValueError, match="cut.jpg.*truncated"):
        read_rgb(cut)
