"""The port's own copy of vision_compression_project_tpu/config.py: the
request-surface defaults, the runtime fields the paths read (overridable
through the environment, after the first `.env` of the discovery chain is
loaded, as the reference does at import), the shipped-checkpoint resolution
of the extraction and answer models, and the service's artifact root.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Optional

from .utils.env import load_env_chain

load_env_chain()

# ---------------------------------------------------------------------------
# Request-surface defaults (identical to the reference API surface).
# ---------------------------------------------------------------------------
DEFAULT_DPI = 150
SCRIPTS_DEFAULT_DPI = 200
DEFAULT_START_PAGE = 1
DEFAULT_TOP_K = 8
DEFAULT_MAX_CHARS_PER_PAGE = 1500
EXCERPT_CHARS = 250          # retrieved-page excerpt length
TRUNCATION_MARKER = "... [truncated]"

# Answer-generation budget, kept from the reference's API configuration.
MAX_OUTPUT_TOKENS_EXTRACTION = 2048
MAX_OUTPUT_TOKENS_ANSWERING = 8192
GENERATION_TEMPERATURE = 0.0

# The four keys of every page JSON.
EXTRACTION_SCHEMA_KEYS = ("page_number", "markdown", "entities", "summary")


def _env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Process-wide runtime knobs, overridable via environment."""

    # Extraction engine: "auto" (text layer if present, else vlm), "text", "vlm".
    extract_engine: str = _env_str("VCP_EXTRACT_ENGINE", "auto")
    # Answering engine: "auto", "analytic", "extractive", "lm".
    answer_engine: str = _env_str("VCP_ANSWER_ENGINE", "auto")
    # Retrieval mode: "single" (one pooled vector per page) or "multi"
    # (multi-vector MaxSim, index/multivector.py).
    retrieval_mode: str = _env_str("VCP_RETRIEVAL", "single")
    # Embedding backend: "hash" (hashed n-gram projection) or "neural".
    embed_backend: str = _env_str("VCP_EMBED_BACKEND", "hash")
    embed_dim: int = _env_int("VCP_EMBED_DIM", 512)
    embed_batch_size: int = _env_int("VCP_EMBED_BATCH", 32)
    # Model preset for extraction; "auto" = the best shipped preset.
    model_preset: str = _env_str("VCP_MODEL_PRESET", "auto")
    checkpoint_dir: Optional[str] = os.environ.get("VCP_CHECKPOINT_DIR")
    # Device batch size for page extraction.
    extract_batch_size: int = _env_int("VCP_EXTRACT_BATCH", 16)
    index_root: str = _env_str("VCP_INDEX_ROOT", "tmp/_index")
    # Sharded retrieval: '1' force, '0' disable, 'auto' = shard when the
    # process group holds more than one rank (index/store.py::_serving_mesh).
    index_sharded: str = _env_str("VCP_INDEX_SHARDED", "auto")
    # Device of the runners the entry points build themselves (extraction's
    # and the answer model's): the card unless the caller asks for "cpu".
    device: str = _env_str("VCP_DEVICE", "cuda")


RUNTIME = RuntimeConfig()

# Shipped (in-repo) checkpoints: checkpoints/default/<preset>/params_NNNNNNNN/.
SHIPPED_CHECKPOINT_ROOT = Path(__file__).resolve().parents[1] / "checkpoints" / "default"
# Where the port's ship step (scripts/ship_checkpoint.py) writes by default:
# the port saves checkpoint.pt, which the JAX package cannot read, so it never
# writes into SHIPPED_CHECKPOINT_ROOT.
PORT_SHIP_ROOT = SHIPPED_CHECKPOINT_ROOT.parent / "torch"

# Resolution order for VCP_MODEL_PRESET=auto: the largest preset shipped.
_PRESET_PREFERENCE = ("prod", "base", "ocr_real", "ocr_bpe", "ocr_demo", "tiny")


def shipped_checkpoint_dir(preset: str) -> Optional[str]:
    d = SHIPPED_CHECKPOINT_ROOT / preset
    return str(d) if d.is_dir() and any(d.glob("params_*")) else None


def shipped_meta(preset: str) -> dict:
    """The checkpoint's meta.json (render and tasks it was trained on); {} if absent."""
    try:
        return json.loads((SHIPPED_CHECKPOINT_ROOT / preset / "meta.json").read_text())
    except (OSError, ValueError):
        return {}


def resolve_model_preset() -> str:
    """RUNTIME.model_preset, with "auto" meaning the best preset shipped, else tiny."""
    if RUNTIME.model_preset != "auto":
        return RUNTIME.model_preset
    for name in _PRESET_PREFERENCE:
        if shipped_checkpoint_dir(name):
            return name
    return "tiny"


def resolve_checkpoint_dir(preset: str) -> Optional[str]:
    """Explicit VCP_CHECKPOINT_DIR wins; else the shipped checkpoint."""
    return RUNTIME.checkpoint_dir or shipped_checkpoint_dir(preset)


def resolve_answer_preset() -> Optional[tuple]:
    """(preset, ckpt_dir) of the best shipped checkpoint whose meta declares
    answer-task training, or None. VCP_ANSWER_PRESET forces a preset; an
    explicit VCP_CHECKPOINT_DIR whose meta.json declares 'answer' wins."""
    if RUNTIME.checkpoint_dir:
        try:
            meta = json.loads((Path(RUNTIME.checkpoint_dir) / "meta.json").read_text())
        except (OSError, ValueError):
            meta = {}
        if "answer" in meta.get("tasks", ()):
            return resolve_model_preset(), RUNTIME.checkpoint_dir
        return None
    forced = os.environ.get("VCP_ANSWER_PRESET")
    for name in (forced,) if forced else _PRESET_PREFERENCE:
        d = shipped_checkpoint_dir(name)
        if d and "answer" in shipped_meta(name).get("tasks", ()):
            return name, d
    return None


# Base directory for the service's per-document artifacts.
BASE_TMP_DIR = Path(os.environ.get("VCP_TMP_DIR", "tmp"))
