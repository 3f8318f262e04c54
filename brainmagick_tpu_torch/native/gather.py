"""Build and bind the native batch gather (``gather.cpp``).

``g++`` compiles the source at first use into
``_build/libbm_gather_<hash>.so``, where the hash covers the source and
the flags, so an edited source never loads a library built from another
one. A build writes a file named after its process and thread and renames
it onto the library atomically (``os.replace``), so that processes and
threads that build at once each load a whole library; the file is removed
whatever happens, and a failed build raises ``GatherBuildError``: there is
no fallback, since the loader's batches come from this library.

``gather_epochs`` and ``gather_track`` assemble a batch in float32 (numpy)
or bfloat16 (a CPU tensor, whose bits the library writes through a uint16
array: numpy has no bfloat16). Their plain versions are
``dataset.gather_epochs`` and ``dataset.gather_track``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import signal
import subprocess
import threading
import typing as tp
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parent / "gather.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
#: seconds a compile may take
BUILD_TIMEOUT = 300

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
#: C signature of each entry point: (argtypes, restype)
SIGNATURES = {
    # (raw, n_channels, total_samples, starts, batch, n_times,
    #  out_channels, baseline_len, out, n_threads)
    **{name: ((_P, _I64, _I64, _P, _I64, _I64, _I64, _I64, _P,
               ctypes.c_int), ctypes.c_int)
       for name in ("gather_epochs", "gather_epochs_bf16")},
    # (track, dim, total_samples, starts, batch, n_times, out, n_threads)
    **{name: ((_P, _I64, _I64, _P, _I64, _I64, _P, ctypes.c_int),
              ctypes.c_int)
       for name in ("gather_track", "gather_track_bf16")},
}
_BUILD_LOCK = threading.Lock()


class GatherBuildError(RuntimeError):
    """g++ is missing or refused the source; the message holds its log."""


def library_path(source: tp.Optional[Path] = None,
                 build_dir: tp.Optional[Path] = None) -> Path:
    """Where the library built from `source` (``SOURCE`` when None) lives
    in `build_dir` (``BUILD_DIR``): its name holds a hash of the source's
    bytes and the flags."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(Path(source or SOURCE).read_bytes())
    return Path(build_dir or BUILD_DIR) / \
        f"libbm_gather_{digest.hexdigest()[:16]}.so"


def build(source: tp.Optional[Path] = None,
          build_dir: tp.Optional[Path] = None) -> Path:
    """Compile `source` (``SOURCE`` when None) into `build_dir`
    (``BUILD_DIR``) unless the library of its hash exists; returns its
    path. Raises GatherBuildError when g++ is missing, fails or times
    out, leaving no file behind."""
    source = Path(source or SOURCE)
    path = library_path(source, build_dir)
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise GatherBuildError("g++ not found on PATH: the native gather "
                               "cannot be built")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(
        f"{path.name}.tmp.{os.getpid()}.{threading.get_ident()}")
    cmd = [cxx, *CXX_FLAGS, str(source), "-o", str(tmp)]
    # a session of its own: a timeout kills g++ and the compiler, assembler
    # and linker it started, so that none writes the file after it is gone
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        try:
            _, err = proc.communicate(timeout=BUILD_TIMEOUT)
        except subprocess.TimeoutExpired as error:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise GatherBuildError(f"g++ took over {BUILD_TIMEOUT} s: "
                                   f"{' '.join(cmd)}") from error
        if proc.returncode != 0:
            raise GatherBuildError(f"g++ failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{err}")
        os.replace(tmp, path)          # atomic: never half a library
    finally:
        tmp.unlink(missing_ok=True)
    return path


@functools.cache
def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def library(source: tp.Optional[Path] = None,
            build_dir: tp.Optional[Path] = None) -> ctypes.CDLL:
    """The library built from `source` as it is now (built first when
    needed), with every entry point's C signature declared."""
    with _BUILD_LOCK:
        return _load(build(source, build_dir))


@functools.cache
def _package_library() -> ctypes.CDLL:
    """The package's library, hashed and loaded once a process."""
    return library()


def _check_bounds(starts: np.ndarray, n_times: int, total: int,
                  what: str) -> None:
    if len(starts) and (starts.min() < 0
                        or starts.max() + n_times > total):
        raise IndexError(f"{what} window outside the recording")


def _rows(array: np.ndarray) -> np.ndarray:
    """`array` as C-contiguous float32 rows (itself when it is one, as a
    recording's memmap is)."""
    return np.ascontiguousarray(array, dtype=np.float32)


def _output(shape: tp.Tuple[int, ...], bf16: bool
            ) -> tp.Tuple[np.ndarray, tp.Any]:
    """(the array the library writes, the batch it is): float32, or
    uint16 bits seen as a bfloat16 CPU tensor."""
    if not bf16:
        out = np.empty(shape, dtype=np.float32)
        return out, out
    bits = np.empty(shape, dtype=np.uint16)
    return bits, torch.from_numpy(bits).view(torch.bfloat16)


def _bf16(dtype: tp.Optional[str]) -> bool:
    if dtype in (None, "float32"):
        return False
    if dtype == "bfloat16":
        return True
    raise ValueError(f"the native gather writes float32 or bfloat16, not "
                     f"{dtype!r}")


def gather_epochs(raw: np.ndarray, starts: np.ndarray, n_times: int,
                  out_channels: int, baseline_len: int = 0,
                  dtype: tp.Optional[str] = None, n_threads: int = 0
                  ) -> tp.Any:
    """[C, T_total] raw and [B] start samples -> [B, out_channels, n_times],
    each epoch less its mean over its first `baseline_len` samples, the
    channels past C zero: a float32 array, or with `dtype` 'bfloat16' a
    bfloat16 CPU tensor. `n_threads` 0 takes one thread a core."""
    bf16 = _bf16(dtype)
    raw = _rows(raw)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    _check_bounds(starts, n_times, raw.shape[1], "epoch")
    bits, batch = _output((len(starts), out_channels, n_times), bf16)
    lib = _package_library()
    fn = lib.gather_epochs_bf16 if bf16 else lib.gather_epochs
    status = fn(raw.ctypes.data, raw.shape[0], raw.shape[1],
                starts.ctypes.data, len(starts), n_times, out_channels,
                baseline_len, bits.ctypes.data, n_threads)
    if status != 0:
        raise IndexError(f"gather_epochs refused raw {raw.shape}, "
                         f"{out_channels} channels, baseline {baseline_len} "
                         f"of {n_times} samples")
    return batch


def gather_track(track: np.ndarray, starts: np.ndarray, n_times: int,
                 dtype: tp.Optional[str] = None, n_threads: int = 0
                 ) -> tp.Any:
    """[D, T_total] track and [B] starts -> [B, D, n_times], a float32
    array or with `dtype` 'bfloat16' a bfloat16 CPU tensor."""
    bf16 = _bf16(dtype)
    track = _rows(track)
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    _check_bounds(starts, n_times, track.shape[1], "track")
    bits, batch = _output((len(starts), track.shape[0], n_times), bf16)
    lib = _package_library()
    fn = lib.gather_track_bf16 if bf16 else lib.gather_track
    status = fn(track.ctypes.data, track.shape[0], track.shape[1],
                starts.ctypes.data, len(starts), n_times, bits.ctypes.data,
                n_threads)
    if status != 0:
        raise IndexError(f"gather_track refused track {track.shape}")
    return batch
