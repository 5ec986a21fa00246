"""Build and load the port's CUDA kernel libraries.

Each source under `csrc/` holds kernels behind a plain C interface. It is
compiled at first use with `nvcc` for sm_90a into `build/zutis_tpu_torch/`
beside the package (a directory git ignores), keyed by a hash of the source,
the headers beside it and the flags, and loaded with ctypes. A missing `nvcc`
or a failed build raises.
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


def _digest(source: Path) -> str:
    """Hash of what a build of `source` compiles: the source, every `*.cuh`
    header in its directory and below (names and contents, so that an edit
    to a header alone rebuilds), and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.rglob("*.cuh")):
        h.update(header.relative_to(source.parent).as_posix().encode() + b"\0")
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(source: Path, stem: str) -> tuple[Path, float, str]:
    """Compile `source` into `BUILD_DIR/<stem>_<digest>.so` if this source,
    its headers and these flags have not been built yet. Returns (library
    path, seconds spent compiling, compiler output with ptxas's per-kernel
    resource report; empty when no build was needed)."""
    lib_path = BUILD_DIR / f"{stem}_{_digest(source)}.so"
    if lib_path.exists():
        return lib_path, 0.0, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)],
        capture_output=True, text=True,
    )
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed to build {source} (exit {proc.returncode}):\n"
            f"{proc.stderr}{proc.stdout}"
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
