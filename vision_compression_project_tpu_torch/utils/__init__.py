from .json_utils import safe_json_loads, strip_code_fences
from .metrics import METRICS, MetricsRegistry

__all__ = ["METRICS", "MetricsRegistry", "safe_json_loads", "strip_code_fences"]
