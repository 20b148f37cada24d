"""Tiny .env loader (no python-dotenv dependency): the port's copy of
vision_compression_project_tpu/utils/env.py. The port sits at the same depth,
so the repo-root .env it finds is the JAX package's.

Mirrors the reference's discovery chain (backend/app/config.py:9-21):
package-adjacent .env -> ./.env -> ~/.env, first hit wins.  Values already in
os.environ are never overridden.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Iterable, Optional


def _parse_env_file(path: Path) -> dict:
    out = {}
    try:
        text = path.read_text(encoding="utf-8")
    except OSError:
        return out
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        key = key.strip()
        value = value.strip().strip('"').strip("'")
        if key:
            out[key] = value
    return out


def load_env_chain(extra_paths: Optional[Iterable[Path]] = None) -> Optional[Path]:
    """Load the first existing .env from the discovery chain into os.environ.

    Returns the path loaded, or None.
    """
    candidates = list(extra_paths or [])
    candidates += [
        Path(__file__).resolve().parent.parent.parent / ".env",  # repo root
        Path(".env"),
        Path.home() / ".env",
    ]
    for candidate in candidates:
        candidate = Path(candidate)
        if candidate.exists():
            for key, value in _parse_env_file(candidate).items():
                os.environ.setdefault(key, value)
            return candidate
    return None
