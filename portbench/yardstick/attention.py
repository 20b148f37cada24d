"""The least time of one attention call (K1) and of its backward: a frozen
copy of chip_smoke.py's `bound_ms` and `backward_bound_ms`.

Forward: q, k, v and kv_len read once, o written once; 4*D operations per
(query, key) pair that the masks leave, counted from the call's key lengths
(every query row against its row's kv_len keys). Backward: q, k, v, the
output, its gradient, the row log-sum-exp and kv_len read once, dq, dk, dv
written once; 10*D operations per pair. The larger of the byte time and the
operation time bounds the call."""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .peaks import HBM_BYTES_PER_S, peak_flops

_ITEM = {"bfloat16": 2, "float32": 4}


@dataclasses.dataclass(frozen=True)
class AttnShape:
    """One kind of attention call: (b, h, hkv, s, d), causal or not, each
    row's key length, and how many such calls a unit of work makes."""

    name: str
    b: int
    h: int
    hkv: int
    s: int
    d: int
    causal: bool
    kv_len: Tuple[int, ...]
    calls: int


def _pairs(sh: AttnShape) -> int:
    rows = np.arange(sh.s)
    return sum(int(np.minimum(rows + 1, n).sum()) if sh.causal else n * sh.s for n in sh.kv_len)


def bound_ms(sh: AttnShape, dtype: str) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations") of one forward call."""
    item = _ITEM[dtype]
    nbytes = (2 * sh.b * sh.h + 2 * sh.b * sh.hkv) * sh.s * sh.d * item + 4 * sh.b
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 4 * sh.d * _pairs(sh) * sh.h / peak_flops(dtype) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def backward_bound_ms(sh: AttnShape, dtype: str) -> Tuple[float, str]:
    """(least time in ms, "bytes" or "operations") of one backward call."""
    item = _ITEM[dtype]
    nbytes = (4 * sh.b * sh.h + 4 * sh.b * sh.hkv) * sh.s * sh.d * item + 4 * sh.b * sh.h * sh.s + 4 * sh.b
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 10 * sh.d * _pairs(sh) * sh.h / peak_flops(dtype) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def uses_kernel(s: int, d: int) -> bool:
    """Whether the port sends a whole-sequence call to K1 (models/layers.py
    `use_flash`): s >= 128 and head_dim % 8 == 0."""
    return s >= 128 and d % 8 == 0


def encoder_calls(cfg: dict, batch: int) -> List[AttnShape]:
    """The vision encoder's attention calls for a batch of pages: the
    windowed stage (one call a block over every window of every page) and
    the global stage."""
    v = cfg["vision"]
    grid = v["image_size"] // v["patch"]
    win = min(v["window"], grid)
    nw = grid // win
    side = grid // v["downsample"]
    local = AttnShape("encoder_windows", batch * nw * nw, v["heads_local"], v["heads_local"], win * win,
                      v["dim_local"] // v["heads_local"], False, (win * win,) * (batch * nw * nw), v["depth_local"])
    glob = AttnShape("encoder_global", batch, v["heads_global"], v["heads_global"], side * side,
                     v["dim_global"] // v["heads_global"], False, (side * side,) * batch, v["depth_global"])
    return [local, glob]


def decoder_call(cfg: dict, batch: int, s: int, kv_len: int, name: str) -> AttnShape:
    """The decoder's causal attention over s positions, kv_len of them real."""
    d = cfg["decoder"]
    return AttnShape(name, batch, d["heads"], d["kv_heads"], s, d["head_dim"], True, (kv_len,) * batch, d["depth"])


def kernel_calls(shapes: List[AttnShape]) -> List[AttnShape]:
    """The shapes that the port sends to K1."""
    return [sh for sh in shapes if uses_kernel(sh.s, sh.d)]


def total_bound_ms(shapes: List[AttnShape], dtype: str, backward: bool = False) -> float:
    """Sum of the least times of every call the shapes make."""
    fn = backward_bound_ms if backward else bound_ms
    return sum(fn(sh, dtype)[0] * sh.calls for sh in shapes)
