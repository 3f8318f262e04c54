"""Global data paths: the study folders and the cache folder.

Port of ``brainmagick_tpu/env.py``. The paths come from the environment
(``BM_TPU_CACHE``, ``BM_TPU_STUDY_<NAME>``), or are set for a while with
``env.temporary(...)`` / ``env.temporary_from_args(args)``. The port may
share the JAX package's cache folder: every entry it writes there carries
its own backend tag (``cache.BACKEND``).
"""

from __future__ import annotations

import contextlib
import os
import typing as tp
from pathlib import Path


class Env:
    """Singleton holding the global data paths."""

    _instance: tp.Optional["Env"] = None

    def __new__(cls) -> "Env":
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __init__(self) -> None:
        if getattr(self, "_initialized", False):
            return
        self._initialized = True
        prefix = "BM_TPU_STUDY_"
        self.studies: tp.Dict[str, Path] = {
            key[len(prefix):].lower(): Path(val)
            for key, val in os.environ.items()
            if key.startswith(prefix) and val}
        cache = os.environ.get("BM_TPU_CACHE")
        self.cache: tp.Optional[Path] = Path(cache) if cache else None

    @contextlib.contextmanager
    def temporary(self, **kwargs: tp.Any) -> tp.Iterator[None]:
        """Replace attributes (``cache``, ``studies``) for a while."""
        saved: tp.Dict[str, tp.Any] = {}
        for key, val in kwargs.items():
            if isinstance(val, str):
                val = Path(val)
            saved[key] = getattr(self, key)
            setattr(self, key, val)
        try:
            yield
        finally:
            for key, val in saved.items():
                setattr(self, key, val)

    @contextlib.contextmanager
    def temporary_from_args(self, args: tp.Any) -> tp.Iterator[None]:
        """Push a config's ``cache`` (and ``study_paths``, when it has
        them) into the env for a while."""
        kwargs: tp.Dict[str, tp.Any] = {}
        cache = getattr(args, "cache", None)
        if cache is not None:
            kwargs["cache"] = Path(cache)
        study_paths = getattr(args, "study_paths", None)
        if study_paths:
            kwargs["studies"] = {**self.studies, **{
                name: Path(p) for name, p in dict(study_paths).items()}}
        with self.temporary(**kwargs):
            yield

    def environ(self) -> tp.Dict[str, str]:
        """``os.environ`` with the paths as they are now
        (``BM_TPU_CACHE``, ``BM_TPU_STUDY_<NAME>``): what a subprocess
        needs to see the same data as this process."""
        out = {key: val for key, val in os.environ.items()
               if not key.startswith("BM_TPU_STUDY_")
               and key != "BM_TPU_CACHE"}
        out.update({f"BM_TPU_STUDY_{name.upper()}": str(path)
                    for name, path in self.studies.items()})
        if self.cache is not None:
            out["BM_TPU_CACHE"] = str(self.cache)
        return out


env = Env()
