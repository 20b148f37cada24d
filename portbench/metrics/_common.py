"""Readings that several metrics' files share. Kernel names are those of
the port's CUDA sources (kernels/flash_attention.cu, flash_attention_bwd.cu)."""

from __future__ import annotations

from typing import Optional

K1_FWD = r"\bflash_fwd(_scalar)?_kernel\b"
K1_BWD = r"\b(delta_kernel|dkdv_kernel|dq_kernel|dkdv_scalar_kernel|dq_scalar_kernel)\b"


def idle_percent(ctx) -> Optional[float]:
    """The traced window's share with no device operation running."""
    tr = ctx.trace
    if tr is None or tr.window is None or tr.window_s() <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s())


def roofline_percent(bound_ms: float, seconds: float) -> Optional[float]:
    """The least time over the measured device time, or nothing where no
    such operation ran."""
    if seconds <= 0:
        return None
    return 100.0 * bound_ms * 1e-3 / seconds
