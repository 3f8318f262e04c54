"""Build the package's CUDA sources into one shared library at first use.

``nvcc`` compiles every ``csrc/*.cu`` file for Hopper (``sm_90a``) into
``_build/libbm_kernels_<hash>.so``; the hash covers the sources and the
flags, so an edited source builds a new library. The sources expose a
plain C interface (no PyTorch headers), so a build takes seconds, and the
library is loaded with ``ctypes``. Each exported function returns the
``cudaError_t`` of its launches; the Python wrappers raise when it is not
0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
#: C signature of each exported function: (argtypes, restype)
SIGNATURES = {
    # (a, b, is_bf16, workspace, out, M, N, K, splits, k_chunk, stream)
    "bm_nt_matmul": ((_P, _P, ctypes.c_int, _P, _P, _I64, _I64, _I64,
                      ctypes.c_int, _I64, _P), ctypes.c_int),
    # (x, w, is_bf16, y, workspace, s, ss, B, C, T, O, k, dilation, stream)
    "bm_conv_stats": ((_P, _P, ctypes.c_int, _P, _P, _P, _P, _I64, _I64,
                       _I64, _I64, ctypes.c_int, ctypes.c_int, _P),
                      ctypes.c_int),
}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source; the message holds its log."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise KernelBuildError(
        "nvcc not found on PATH, under $CUDA_HOME or /usr/local/cuda")


def _sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libbm_kernels_{digest.hexdigest()[:16]}.so"


def build() -> tuple:
    """Compile the sources unless the library for their hash exists.
    Returns (path, nvcc log or "" when nothing was built)."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.tmp.{os.getpid()}")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path, proc.stdout + proc.stderr


@functools.cache
def library() -> ctypes.CDLL:
    """The built library with every function's C signature declared."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def check_status(name: str, status: int) -> None:
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{status}")
