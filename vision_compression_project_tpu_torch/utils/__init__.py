from .dirs import ensure_dirs
from .env import load_env_chain
from .json_utils import safe_json_loads, strip_code_fences
from .metrics import METRICS, MetricsRegistry
from .retry import retry

__all__ = [
    "METRICS",
    "MetricsRegistry",
    "ensure_dirs",
    "load_env_chain",
    "retry",
    "safe_json_loads",
    "strip_code_fences",
]
