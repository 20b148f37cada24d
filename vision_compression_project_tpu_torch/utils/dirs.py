"""Directory helpers: the port's copy of vision_compression_project_tpu/utils/dirs.py."""

from __future__ import annotations

from pathlib import Path
from typing import Iterable, Union


def ensure_dirs(*paths: Union[str, Path, Iterable]) -> None:
    """Create each directory (and parents) if missing."""
    for p in paths:
        if isinstance(p, (list, tuple)):
            ensure_dirs(*p)
        else:
            Path(p).mkdir(parents=True, exist_ok=True)
