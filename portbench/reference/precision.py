"""The precision the reference computes in. `Precision()` is float32; with
`low=True` it is the control: the nearest precision below the one each part
of the configuration states, fp8 (e4m3, one scale per tensor) for the
operands of every product that the configuration computes in bfloat16, and
bfloat16 for those it computes in float32 (the router and the unembed).
Values are rounded on the way in and the gradient passes straight through."""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch

FP8_MAX = 448.0


def _straight_through(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    return x + (rounded - x).detach() if x.requires_grad else rounded


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float().clamp(min=1e-12)
    scale = amax / FP8_MAX
    q = (x.detach().float() / scale).to(torch.float8_e4m3fn).float() * scale
    return _straight_through(x, q.to(x.dtype))


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return _straight_through(x, x.detach().to(torch.bfloat16).to(x.dtype))


class Precision:
    def __init__(self, low: bool = False):
        self.low = low

    def op(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product the configuration computes in bf16."""
        return round_fp8(x) if self.low else x

    def op32(self, x: torch.Tensor) -> torch.Tensor:
        """An operand of a product the configuration computes in f32."""
        return round_bf16(x) if self.low else x


@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """float32 products in float32: TF32 off for matmuls and convolutions,
    restored after."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    precision = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(precision)
