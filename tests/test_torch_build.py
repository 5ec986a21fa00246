"""The port's builder (zutis_tpu_torch/ops/_build.py) on the CPU: a
library is keyed by a digest of its source, the headers beside it and the
compiler's flags, so an edit to a header alone rebuilds every library that
includes it. For the CUDA sources no nvcc is needed: only the digest is
computed (the four that include the shared header: each test runs for
each). The
host C++ source (the RLE codec) is built with g++ here: a missing g++ or a
failed build raises, and six processes loading it at once from an empty
build directory all get a working library."""
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from zutis_tpu_torch.ops import _build

SOURCES = ["attention_probes.cu", "flash_attention.cu", "nms.cu",
           "mask_iou.cu"]
REPO = Path(__file__).resolve().parents[1]


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


# ---- the host C++ build (g++), which the RLE codec uses

HOST_SOURCE = _build.CSRC.parent / "native" / "rle.cc"

_LOAD_AT_ONCE = r"""
import sys, time
from pathlib import Path
import numpy as np
from zutis_tpu_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
from zutis_tpu_torch import native
time.sleep(max(0.0, float(sys.argv[2]) - time.time()))  # start together
m = np.zeros((7, 5), np.uint8)
m[2:5, 1:4] = 1
assert native.native_encode(m) == "9340005", native.native_encode(m)
print("loaded", native.load_rle_lib()._name)
"""


@pytest.fixture
def native_dir(tmp_path):
    """A copy of the port's native directory."""
    return shutil.copytree(HOST_SOURCE.parent, tmp_path / "native")


def test_host_digest_changes_with_source_header_and_flags(native_dir,
                                                          monkeypatch):
    source = native_dir / "rle.cc"
    before = _build._digest(source)
    assert before == _build._digest(HOST_SOURCE)
    (native_dir / "extra.h").write_text("#pragma once\n")
    with_header = _build._digest(source)
    assert with_header != before
    monkeypatch.setattr(_build, "HOST_FLAGS", _build.HOST_FLAGS + ("-g",))
    assert _build._digest(source) != with_header
    # the nvcc flags key the CUDA sources only
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-G",))
    assert _build._digest(source) == _build._digest(source)


def test_host_build_without_gxx_raises(native_dir, monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        _build.build(native_dir / "rle.cc", "librle")


def test_failed_host_build_raises_and_leaves_nothing(native_dir, monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    source = native_dir / "rle.cc"
    source.write_text(source.read_text() + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
        _build.build(source, "librle")
    assert list((tmp_path / "build").iterdir()) == []


def test_six_processes_load_the_codec_at_once(tmp_path):
    """From an empty build directory, six processes that load the codec
    together all get a working library: each builds under a name of its
    own and renames it into place, so none loads half of one."""
    build_dir = tmp_path / "build"
    start = time.time() + 4.0
    procs = [subprocess.Popen(
        [sys.executable, "-c", _LOAD_AT_ONCE, str(build_dir), str(start)],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(6)]
    outs = []
    for proc in procs:
        out, err = proc.communicate(timeout=120)
        outs.append((proc.returncode, out, err))
    assert [rc for rc, _, _ in outs] == [0] * 6, outs
    libs = sorted(build_dir.iterdir())
    assert [p.suffix for p in libs] == [".so"], libs  # no temporary left
    assert all(out.split()[-1] == str(libs[0]) for _, out, _ in outs)
