"""Build the package's CUDA sources into one shared library at first use.

``nvcc`` compiles every ``csrc/*.cu`` file for Hopper (``sm_90a``), one
process per source, all started together, and links the objects into
``_build/libbm_kernels_<hash>.so``; the hash covers the sources, the
headers they share (``csrc/*.cuh``) and the flags, so an edited source or
header builds a new library. The sources expose a
plain C interface (no PyTorch headers), so a build takes seconds, and the
library is loaded with ``ctypes``. It links only the CUDA runtime:
``cuTensorMapEncodeTiled``, which lives in ``libcuda``, is looked up
through the runtime. Each exported function returns the
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
#: C signature of each exported function: (argtypes, restype)
SIGNATURES = {
    # (a, b, is_bf16, a_split, workspace, out, M, N, K, width, splits,
    #  k_chunk, stream)
    "bm_nt_matmul": ((_P, _P, ctypes.c_int, _P, _P, _P, _I64, _I64, _I64,
                      ctypes.c_int, ctypes.c_int, _I64, _P), ctypes.c_int),
    # (x, w_op, is_bf16, y, workspace, s, ss, B, C, T, T_pad, O, k,
    #  dilation, width, stages, stream)
    "bm_conv_stats_tc": ((_P, _P, ctypes.c_int, _P, _P, _P, _P, _I64, _I64,
                          _I64, _I64, _I64, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, _P), ctypes.c_int),
    # (x, hi, lo, count4, stream)
    "bm_split_tf32": ((_P, _P, _P, _I64, _P), ctypes.c_int),
    # (meg, is_bf16, center, scale, rec, out, peak, B, C, T, R, limit, clip,
    #  rows, magic, shift, stream)
    "bm_normalize_clamp_peak": ((_P, ctypes.c_int, _P, _P, _P, _P, _P, _I64,
                                 _I64, _I64, _I64, ctypes.c_float,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_uint,
                                 ctypes.c_int, _P), ctypes.c_int),
    # (x, type, partial, out, N, K, splits, stream)
    "bm_inv_norms": ((_P, ctypes.c_int, _P, _P, _I64, _I64, ctypes.c_int,
                      _P), ctypes.c_int),
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
    digest = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _sources() + sorted(CSRC_DIR.glob("*.cuh")):
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
    nvcc = _nvcc()
    objects, procs = [], []
    for src in _sources():
        obj = tmp.with_name(f"{tmp.name}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        objects.append(obj)
        procs.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = ""
    try:
        for cmd, proc in procs:
            out, _ = proc.communicate()
            log += out
            if proc.returncode != 0:
                raise KernelBuildError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                    f"{out}")
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp), *map(str, objects)]
        linked = subprocess.run(cmd, capture_output=True, text=True)
        log += linked.stdout + linked.stderr
        if linked.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({linked.returncode}): {' '.join(cmd)}\n"
                f"{linked.stdout}\n{linked.stderr}")
        # atomic: a concurrent build never sees half a file
        os.replace(tmp, path)
    finally:
        for _, proc in procs:  # a failed build stops the other compiles
            proc.kill()
            proc.wait()
        for obj in objects:
            obj.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return path, log


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
