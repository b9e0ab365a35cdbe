"""The one directory under which the port keeps what it compiles: the
``nvcc`` libraries of ``csrc/*.cu`` under ``<root>/kernels``
(``kernels/cuda_build.py``) and the g++ libraries of ``native/*.cpp``
under ``<root>/native`` (``native/__init__.py``).

The root is ``<repo>/build`` (listed in ``.gitignore``) unless the
environment variable ``FPV_TORCH_BUILD_ROOT`` names another directory or
``set_root`` is called; ``python -m fastpyvectordb_tpu_torch.prime --cache
DIR`` builds into ``DIR``, and a serving process started with
``FPV_TORCH_BUILD_ROOT=DIR`` loads those libraries instead of compiling
them again.  Libraries are named by a hash of their sources and flags, so
a stale file is never loaded.  This module imports neither torch nor the
compilers."""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Union

ENV = "FPV_TORCH_BUILD_ROOT"
DEFAULT = Path(__file__).resolve().parents[1] / "build"
_root: Optional[Path] = None


def root() -> Path:
    """The build root: ``set_root``'s, else ``$FPV_TORCH_BUILD_ROOT``'s,
    else ``<repo>/build``."""
    if _root is not None:
        return _root
    env = os.environ.get(ENV)
    return Path(env) if env else DEFAULT


def path(kind: str) -> Path:
    """``<root>/<kind>``: ``"kernels"`` or ``"native"``."""
    return root() / kind


def set_root(directory: Optional[Union[str, Path]]) -> None:
    """Build into and load from ``directory`` from now on (None: back to
    the environment / default).  Libraries a process has already loaded
    stay loaded."""
    global _root
    _root = None if directory is None else Path(directory).resolve()
