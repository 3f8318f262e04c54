"""Content-addressed disk and memory caches.

Port of ``brainmagick_tpu/cache.py``. Keys are SHA1 signatures of
JSON-able arguments; payloads are pickles or numpy memmaps, written
through a rename so that no reader sees a half-written file.

The port may share the JAX package's cache folder but never an entry:
its DSP and mel spectrogram are torch ops whose outputs differ from the
JAX package's in the last bits, so ``BACKEND`` is folded into every key
and every file name the port writes (``tagged``). The preprocessed raw
of the card and of the CPU agree to 1e-5 of max|x| (``chip_smoke.py``),
so the tag names no device.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import pickle
import typing as tp
from pathlib import Path

import numpy as np

from .env import env
from .utils import write_and_rename

logger = logging.getLogger(__name__)

#: the tag of every cache entry the port writes
BACKEND = "torch"


def tagged(filename: str) -> str:
    """`filename` with the backend tag before its suffix:
    ``meg-sr120.npy`` -> ``meg-sr120-torch.npy``."""
    path = Path(filename)
    return f"{path.stem}-{BACKEND}{path.suffix}"


def jsonable(value: tp.Any) -> tp.Any:
    """`value` as a deterministic JSON-able structure."""
    if isinstance(value, dict):
        items = [(jsonable(k), jsonable(v)) for k, v in value.items()]
        items.sort(key=lambda kv: json.dumps(kv[0]))
        return dict(items)
    if isinstance(value, (list, tuple)):
        return [jsonable(v) for v in value]
    if isinstance(value, Path):
        return str(value)
    if value is None or isinstance(value, (int, float, str, bool)):
        return value
    if hasattr(value, "items"):
        return jsonable(dict(value))
    if dataclasses.is_dataclass(value):
        return jsonable(dataclasses.asdict(value))
    raise ValueError(f"{value!r} is not jsonable.")


def signature(value: tp.Any) -> str:
    """Deterministic 16-hex-digit signature of a JSON-able value."""
    return hashlib.sha1(json.dumps(jsonable(value)).encode()).hexdigest()[:16]


class Cache:
    """Disk cache in ``env.cache/<name>/<sig(BACKEND, args)>-<BACKEND>/``.

    mode='pickle' stores any picklable payload; mode='memmap' stores a
    numpy array, loaded back as a read-only memmap. Without ``env.cache``
    nothing is stored."""

    def __init__(self, name: str, args: tp.Any = None, *,
                 mode: str = "pickle") -> None:
        if mode not in ("pickle", "memmap"):
            raise ValueError(f"mode={mode!r}")
        self._suffix = {"pickle": ".pkl", "memmap": ".npy"}[mode]
        if env.cache is None:
            self.path: tp.Optional[Path] = None
        else:
            self.path = env.cache / name / tagged(
                signature([BACKEND, args]))
            self.path.mkdir(exist_ok=True, parents=True)

    def cache_path(self, key: tp.Any) -> tp.Optional[Path]:
        if self.path is None:
            return None
        return self.path / tagged(signature([BACKEND, key]) + self._suffix)

    def get(self, _computation: tp.Callable[..., tp.Any],
            **kwargs: tp.Any) -> tp.Any:
        """The stored result for `kwargs`, else ``_computation(**kwargs)``,
        stored."""
        path = self.cache_path(kwargs)
        if path is not None and path.exists():
            try:
                if self._suffix == ".pkl":
                    with open(path, "rb") as f:
                        return pickle.load(f)
                return np.lib.format.open_memmap(path, mode="r")
            except (OSError, pickle.UnpicklingError, ValueError) as error:
                logger.warning("Error loading cache file %s: %r", path, error)
        result = _computation(**kwargs)
        if path is not None:
            with write_and_rename(path) as tmp:
                if self._suffix == ".pkl":
                    pickle.dump(result, tmp)
                else:
                    if not isinstance(result, np.ndarray):
                        raise TypeError("the memmap cache stores np.ndarray")
                    np.save(tmp, result)
        return result


class MemoryCache:
    """In-process cache for heavy objects shared between callers."""

    _CACHE: tp.Dict[str, tp.Dict[str, tp.Dict[str, tp.Any]]] = {}

    def __init__(self, name: str, args: tp.Any = None) -> None:
        self.args_sig = signature(args)
        self.name = name
        self._CACHE.setdefault(name, {}).setdefault(self.args_sig, {})

    def get(self, _computation: tp.Callable[..., tp.Any],
            *args: tp.Any, **kwargs: tp.Any) -> tp.Any:
        cache = self._CACHE[self.name][self.args_sig]
        key = signature((self.args_sig, list(args), kwargs))
        if key not in cache:
            cache[key] = _computation(*args, **kwargs)
        return cache[key]
