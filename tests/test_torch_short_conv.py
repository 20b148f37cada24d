"""The gated short conv's kernels (kernels/short_conv.cu) on the CPU: their
arithmetic written out in plain torch, step for step as the kernels do it,
against autograd of the plain path they replace (ShortConv's `_gated`,
`_filter` and `_out`, the projections taken out), bit for bit in bf16 and
f32. It pins the order of every rounding, including the order in which
autograd adds the K slices' gradients of the padded product B * x' (the
last tap's first), which the kernel's backward repeats. Also: the kernels'
wrapper refuses what they do not take before it builds or launches, and a
ShortConv on the CPU runs the plain path and launches nothing.

On the card, tests/test_torch_gpu.py holds the kernels against the plain
path itself (`-k short_conv`).
"""

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from vision_compression_project_tpu_torch import kernels
from vision_compression_project_tpu_torch.models import layers

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# (batch, seq, dim): a row of one position, rows shorter than the taps, a
# run of the kernel's RUN (32) positions and one past it, odd widths.
SHAPES = [(1, 1, 16), (3, 2, 8), (2, 5, 24), (2, kernels.SHORT_CONV_RUN + 3, 40)]


def between(dtype: str, dim: int, k: int, seed: int) -> layers.ShortConv:
    """A ShortConv whose projections are identities: its plain path from h
    (B, S, 3 * dim) to the gated product, as the kernels compute it."""
    conv = layers.ShortConv(dim, k, dtype=dtype)
    conv.in_proj, conv.out_proj = nn.Identity(), nn.Identity()
    with torch.no_grad():
        conv.taps.copy_(torch.randn(dim, k, generator=torch.Generator().manual_seed(seed)))
    return conv


def kernel_forward(h: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """short_conv_fwd's arithmetic, a position at a time over (B, dim)."""
    dt, k, (bsz, s, dim3) = h.dtype, taps.shape[1], h.shape
    dim = dim3 // 3
    b, c, x = h.float().split(dim, dim=-1)
    win = [torch.zeros(bsz, dim)] * (k - 1)  # P at t - k + 1 .. t - 1
    out = []
    for t in range(s):
        p = (b[:, t] * x[:, t]).to(dt).float()
        y = win[0] * taps[:, 0]
        for j in range(1, k - 1):
            y = y + win[j] * taps[:, j]
        y = y + p * taps[:, k - 1]
        out.append((y * c[:, t]).to(dt))
        win = win[1:] + [p]
    return torch.stack(out, dim=1)


def kernel_backward(h: torch.Tensor, taps: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """short_conv_bwd's gradient of h, walking positions as a thread walks
    them: at o, dC(o), dY(o) and its k contributions T(dY(o) w_j) to dP at
    o - k + 1 + j, each added to that position's sum so far in the compute
    dtype (+0 past the row's end); dP(o - k + 1) is then whole."""
    dt, k, (bsz, s, dim3) = h.dtype, taps.shape[1], h.shape
    dim = dim3 // 3
    b, c, x = h.float().split(dim, dim=-1)
    g = dout.float()
    zero = torch.zeros(bsz, dim)
    win = [zero] * (k - 1)
    pend = [zero] * (k - 1)  # dP at o - k + 1 .. o - 1, so far
    dh = torch.zeros(bsz, s, dim3, dtype=dt)
    for o in range(s + k - 1):
        if o < s:
            p = (b[:, o] * x[:, o]).to(dt).float()
            y = win[0] * taps[:, 0]
            for j in range(1, k - 1):
                y = y + win[j] * taps[:, j]
            y = y + p * taps[:, k - 1]
            dh[:, o, dim:2 * dim] = (g[:, o] * y).to(dt)
            dy = g[:, o] * c[:, o]
            cj = [(dy * taps[:, j]).to(dt).float() for j in range(k)]
        else:
            p, cj = zero, [zero] * k
        pend = [(pend[i] + cj[i]).to(dt).float() for i in range(k - 1)]
        t = o - (k - 1)
        if t >= 0:
            dh[:, t, :dim] = (pend[0] * x[:, t]).to(dt)
            dh[:, t, 2 * dim:] = (pend[0] * b[:, t]).to(dt)
        win = win[1:] + [p]
        pend = pend[1:] + [cj[k - 1]]
    return dh


def taps_grad_f64(h: torch.Tensor, taps: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """The taps' gradient as an f64 sum of the f32 products dY(t) P(t-k+1+j)."""
    k, s, dim = taps.shape[1], h.shape[1], h.shape[2] // 3
    b, c, x = h.float().split(dim, dim=-1)
    pp = F.pad((b * x).to(h.dtype).double(), (0, 0, k - 1, 0))
    dy = (dout.float() * c).double()
    return torch.stack([(dy * pp[:, j:j + s]).sum(dim=(0, 1)) for j in range(k)], dim=1)


def inputs(dtype: str, bsz: int, s: int, dim: int, k: int, seed: int):
    conv = between(dtype, dim, k, seed)
    g = torch.Generator().manual_seed(seed + 1)
    h = torch.randn(bsz, s, 3 * dim, generator=g).to(DTYPES[dtype]).requires_grad_()
    dout = torch.randn(bsz, s, dim, generator=g).to(DTYPES[dtype])
    return conv, h, dout


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k", kernels.SHORT_CONV_TAPS)
@pytest.mark.parametrize("bsz,s,dim", SHAPES)
def test_kernel_steps_equal_the_plain_path(dtype, k, bsz, s, dim):
    """Forward and gradient of h bit-equal to autograd of `_plain`; the
    taps' gradient that autograd sums is the f64 sum of the same products
    within f32 rounding."""
    conv, h, dout = inputs(dtype, bsz, s, dim, k, seed=7 * k + s)
    out = conv._plain(h)
    dh, dtaps = torch.autograd.grad(out, (h, conv.taps), dout)
    taps = conv.taps.detach()
    assert torch.equal(kernel_forward(h.detach(), taps), out)
    assert torch.equal(kernel_backward(h.detach(), taps, dout), dh)
    want = taps_grad_f64(h.detach(), taps, dout)
    assert dtaps.dtype == torch.float32
    assert float((dtaps.double() - want).norm()) <= 1e-6 * float(want.norm())


def test_the_slices_add_last_tap_first():
    """The order matters in bf16: summing the K contributions to dP first
    tap first, instead of autograd's last tap first, changes the gradient."""
    conv, h, dout = inputs("bfloat16", 2, 64, 64, 3, seed=3)
    dh, _ = torch.autograd.grad(conv._plain(h), (h, conv.taps), dout)
    taps = conv.taps.detach()
    assert torch.equal(kernel_backward(h.detach(), taps, dout), dh)
    dim, s = 64, 64
    b, c, x = h.detach().float().split(dim, dim=-1)
    dy = dout.float() * c
    cj = [F.pad((dy * taps[:, j]).to(torch.bfloat16).float(), (0, 0, 0, 2 - j)) for j in range(3)]
    first_tap_first = ((cj[0][:, 2:] + cj[1][:, 1:s + 1]).to(torch.bfloat16).float() + cj[2][:, :s]).to(torch.bfloat16)
    assert not torch.equal((first_tap_first.float() * x).to(torch.bfloat16), dh[..., :dim])


def test_a_cpu_short_conv_takes_the_plain_path():
    conv = layers.ShortConv(16, 3, dtype="bfloat16")
    layers.init_weights_(conv, torch.Generator().manual_seed(0))
    x = torch.randn(2, 5, 16, requires_grad=True)
    kernels.reset_launch_counts()
    out = conv(x)
    out.float().sum().backward()
    assert torch.equal(out, conv._plain(x))
    assert all(n == 0 for n in kernels.launches.values())


def _h(shape=(2, 5, 48), dtype=torch.bfloat16, device="cpu"):
    return torch.zeros(shape, dtype=dtype, device=device)


def _taps(dim=16, k=3, dtype=torch.float32, device="cpu"):
    return torch.zeros((dim, k), dtype=dtype, device=device)


REFUSED = {
    "h of 2 dimensions": lambda: (_h((10, 48)), _taps(), None),
    "h not 3 x dim wide": lambda: (_h((2, 5, 47)), _taps(), None),
    "h of no channels": lambda: (_h((2, 5, 0)), _taps(0), None),
    "h in float16": lambda: (_h(dtype=torch.float16), _taps(), None),
    "taps in bfloat16": lambda: (_h(), _taps(dtype=torch.bfloat16), None),
    "taps of another width": lambda: (_h(), _taps(dim=15), None),
    "one tap": lambda: (_h(), _taps(k=1), None),
    "five taps": lambda: (_h(), _taps(k=5), None),
    "h not contiguous": lambda: (_h((2, 48, 5)).transpose(1, 2), _taps(), None),
    "taps not contiguous": lambda: (_h(), _taps(dim=3, k=16).t(), None),
    "dout of another shape": lambda: (_h(), _taps(), _h((2, 5, 15))),
    "dout of another dtype": lambda: (_h(), _taps(), _h((2, 5, 16), dtype=torch.float32)),
    "dout not contiguous": lambda: (_h(), _taps(), _h((2, 16, 5)).transpose(1, 2)),
    "more runs than the grid takes": lambda: (_h((70000, 4096, 48), device="meta"), _taps(device="meta"), None),
    "the CPU": lambda: (_h(), _taps(), None),
    "the CPU, backward": lambda: (_h(), _taps(), _h((2, 5, 16))),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_the_wrapper_refuses_before_it_builds(case, monkeypatch):
    """Each refused input raises ValueError, with no build and no launch."""
    monkeypatch.setattr(kernels, "_short_conv_lib", lambda: pytest.fail("built"))
    h, taps, dout = REFUSED[case]()
    before = dict(kernels.launches)
    with pytest.raises(ValueError):
        if dout is None:
            kernels.short_conv_fwd(h, taps)
        else:
            kernels.short_conv_bwd(h, taps, dout)
    assert kernels.launches == before
