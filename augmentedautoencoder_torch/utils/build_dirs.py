"""Where the port builds its native libraries (the CUDA kernels, the host
rasterizer): `build/<name>` beside the package in a checkout, or, where that
cannot be written (an installed package in a read-only site-packages),
`$XDG_CACHE_HOME/aae_torch/<name>` (`~/.cache` without XDG_CACHE_HOME)."""

from __future__ import annotations

import os
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[1]


def _writable(path: Path) -> bool:
    """Whether `path`, or its nearest existing ancestor, can be written."""
    while not path.exists():
        path = path.parent
    return os.access(path, os.W_OK)


def build_root(name: str, parent: Path = _PKG_DIR.parent) -> Path:
    """The build directory `name` for a package installed under `parent`."""
    local = Path(parent) / "build" / name
    if _writable(local):
        return local
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return Path(cache) / "aae_torch" / name
