"""The port's kernel builder (zutis_tpu_torch/ops/_build.py) on the CPU: a
library is keyed by a digest of its source, the headers beside it and the
nvcc flags, so an edit to a header alone rebuilds every library that
includes it. No nvcc is needed: only the digest is computed. Both kernel
sources include the shared header, so each test runs for each."""
import shutil

import pytest

from zutis_tpu_torch.ops import _build

SOURCES = ["attention_probes.cu", "flash_attention.cu"]


@pytest.fixture
def csrc(tmp_path):
    """A copy of the port's csrc directory."""
    return shutil.copytree(_build.CSRC, tmp_path / "csrc")


@pytest.mark.parametrize("name", SOURCES)
def test_the_port_has_a_shared_header_beside_its_sources(name):
    assert (_build.CSRC / "hopper.cuh").exists()
    assert '#include "hopper.cuh"' in (_build.CSRC / name).read_text()


@pytest.mark.parametrize("name", SOURCES)
def test_digest_is_stable_for_unchanged_sources(csrc, name):
    source = csrc / name
    assert _build._digest(source) == _build._digest(source)
    assert _build._digest(source) == _build._digest(_build.CSRC / name)


@pytest.mark.parametrize("name", SOURCES)
@pytest.mark.parametrize("edit", ["header", "source", "new header", "flags"])
def test_digest_changes_with_what_the_build_compiles(csrc, monkeypatch, edit,
                                                     name):
    source = csrc / name
    before = _build._digest(source)
    if edit == "header":
        header = csrc / "hopper.cuh"
        header.write_text(header.read_text() + "\n// edited\n")
    elif edit == "source":
        source.write_text(source.read_text() + "\n// edited\n")
    elif edit == "new header":
        (csrc / "extra.cuh").write_text("#pragma once\n")
    else:
        monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build._digest(source) != before


@pytest.mark.parametrize("name", SOURCES)
def test_digest_ignores_files_that_are_not_headers(csrc, name):
    source = csrc / name
    before = _build._digest(source)
    (csrc / "notes.txt").write_text("not compiled\n")
    assert _build._digest(source) == before


@pytest.mark.parametrize("name", SOURCES)
def test_library_path_carries_the_digest(csrc, monkeypatch, tmp_path, name):
    source = csrc / name
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    lib = _build.BUILD_DIR / f"libx_{_build._digest(source)}.so"
    lib.parent.mkdir(parents=True)
    lib.write_bytes(b"")
    # a library already built from this source, headers and flags is reused
    assert _build.build(source, "libx") == (lib, 0.0, "")
