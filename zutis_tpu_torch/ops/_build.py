"""Build and load the port's native libraries.

Each CUDA source under `csrc/` holds kernels behind a plain C interface. It
is compiled at first use with `nvcc` for sm_90a; a host C++ source (`.cc`,
`.cpp`, such as the RLE codec in `native/`) with `g++ -O2 -shared -fPIC`.
Both go into `build/zutis_tpu_torch/` beside the package (a directory git
ignores), keyed by a hash of the source, the headers beside it and the
flags, and are loaded with ctypes. Each build writes a name of its own and
renames it into place, so that processes building the same library at once
never load half of one. A missing compiler or a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "zutis_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # report registers, shared memory and spills
)
# no fused multiply-add: the image library reproduces other libraries'
# float arithmetic operation by operation
HOST_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off")

_loaded: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is not None:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels cannot be built"
    )


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found on PATH: the host C++ library "
                           "cannot be built")
    return found


def _is_cuda(source: Path) -> bool:
    return source.suffix == ".cu"


def _digest(source: Path) -> str:
    """Hash of what a build of `source` compiles: the source, every header
    in its directory and below (`*.cuh` for a CUDA source, `*.h` for a host
    one; names and contents, so that an edit to a header alone rebuilds),
    and the flags."""
    cuda = _is_cuda(source)
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.rglob("*.cuh" if cuda else "*.h")):
        h.update(header.relative_to(source.parent).as_posix().encode() + b"\0")
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS if cuda else HOST_FLAGS).encode())
    return h.hexdigest()[:16]


def build(source: Path, stem: str) -> tuple[Path, float, str]:
    """Compile `source` (nvcc for `.cu`, g++ otherwise) into
    `BUILD_DIR/<stem>_<digest>.so` if this source, its headers and these
    flags have not been built yet. Returns (library path, seconds spent
    compiling, compiler output, with ptxas's per-kernel resource report for
    a CUDA source; empty when no build was needed)."""
    lib_path = BUILD_DIR / f"{stem}_{_digest(source)}.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    if _is_cuda(source):
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    else:
        cmd = [_gxx(), *HOST_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(cmd[0]).name} failed to build {source} (exit "
            f"{proc.returncode}):\n{proc.stderr}{proc.stdout}"
        )
    os.replace(tmp, lib_path)  # atomic: a reader never sees half a library
    return lib_path, seconds, proc.stderr + proc.stdout


def load(source: Path, stem: str,
         bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library built from `source`, loaded once per process; `bind`
    declares its functions' argtypes and restypes."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            path, _, _ = build(source, stem)
            lib = ctypes.CDLL(str(path))
            if _is_cuda(source):
                lib.zutis_cuda_error_string.restype = ctypes.c_char_p
                lib.zutis_cuda_error_string.argtypes = [ctypes.c_int]
            bind(lib)
            _loaded[source] = lib
        return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        msg = lib.zutis_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")
