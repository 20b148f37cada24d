"""The port's flash_attention against the JAX package's flash_attention,
whose Pallas kernel runs in interpret mode on the CPU, at the shapes of
tests/test_ops.py plus a key length of 0 and a causal sequence that is not a
multiple of the 128 block. On a CPU tensor the port runs the kernel's plain
version; the kernel itself is held against it on the card (chip_smoke.py,
tests/test_torch_gpu.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vision_compression_project_tpu.ops.attention import flash_attention as jflash
from vision_compression_project_tpu_torch import kernels
from vision_compression_project_tpu_torch.ops.attention import flash_attention, mha_reference

# f32 on both sides; the Pallas kernel's online softmax sums in another order.
ATOL = 2e-3


def _qkv(seed, b, h, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


CASES = [
    # (b, h, hkv, s, d, kv_len, causal)
    (2, 4, 4, 256, 64, None, False),
    (2, 4, 4, 256, 64, None, True),
    (2, 8, 2, 128, 32, [128, 57], False),
    (2, 4, 2, 128, 32, [0, 100], False),
    (2, 6, 2, 200, 64, [200, 131], True),
    # prod's head dims: 96 (the global vision stage), 128 (the decoder), causal
    # and not, GQA 4:1, ragged key lengths (0 among them).
    (2, 4, 4, 256, 96, None, False),
    (2, 8, 2, 200, 96, [200, 77], True),
    (2, 8, 2, 160, 128, [160, 0], False),
    (2, 8, 2, 320, 128, [258, 131], True),
]


@pytest.mark.parametrize("case", CASES, ids=[str(i) for i in range(len(CASES))])
def test_flash_attention_matches_jax_kernel(case):
    b, h, hkv, s, d, kv_len, causal = case
    q, k, v = _qkv(4, b, h, hkv, s, d)
    jkv = None if kv_len is None else jnp.asarray(kv_len, jnp.int32)
    tkv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), kv_len=jkv, causal=causal))
    got = flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), kv_len=tkv, causal=causal)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)
    if kv_len is not None and 0 in kv_len:
        assert not got[kv_len.index(0)].any()  # an empty key range gives 0


def test_plain_version_bf16_in_bf16_out():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(5, 1, 6, 2, 64, 32))
    out = mha_reference(q, k, v, kv_len=torch.tensor([40]), causal=True)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    want = mha_reference(q.float(), k.float(), v.float(), kv_len=torch.tensor([40]), causal=True)
    np.testing.assert_allclose(out.float().numpy(), want.numpy(), atol=2e-2)  # bf16 output rounding


@pytest.mark.parametrize(
    "d,dtype,device,match",
    [(48, torch.float32, "cpu", "head_dim"), (64, torch.float16, "cpu", "dtypes"),
     (64, torch.float32, "cpu", "CUDA")],
)
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(d, dtype, device, match):
    """The launcher checks its operands before it builds or launches."""
    q = torch.zeros((1, 2, 128, d), dtype=dtype, device=device)
    kv_len = torch.full((1,), 128, dtype=torch.int32)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match=match):
        kernels.flash_attention_fwd(q, q, q, kv_len, causal=False, scale=1.0)
    assert kernels.launches == before


@pytest.mark.parametrize("d", [96, 128])
def test_backward_kernel_refuses_prod_head_dims(d):
    """Both kernels take head_dim 96 and 128 (prod): the backward's head-dim
    check passes them, and the wrapper refuses these operands only because
    they lie on the CPU. A head dim the kernels do not take (48) is refused
    as such. Both raise before any build or launch."""
    assert d in kernels.FLASH_HEAD_DIMS and d in kernels.FLASH_BWD_HEAD_DIMS
    lse = torch.zeros((1, 4, 128))
    before = dict(kernels.launches)
    for dim, match in ((d, "CUDA"), (48, "head_dim")):
        q = torch.zeros((1, 4, 128, dim), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match=match):
            kernels.flash_attention_bwd(q, q, q, q, q, lse, None, False, 0.1)
    assert kernels.launches == before


def test_flash_layout_rule():
    """The layout the kernel reads without a copy: the attention layer's
    head-split views of a (B, S, H * D) projection and contiguous tensors
    qualify; a strided last dimension, a stride that is not a multiple of 8
    elements or a base off 16 bytes does not (ops.attention copies those)."""
    proj = torch.zeros((2, 300, 10 * 64), dtype=torch.bfloat16)
    q = proj[..., : 6 * 64].view(2, 300, 6, 64).transpose(1, 2)
    v = proj[..., 8 * 64 :].view(2, 300, 2, 64).transpose(1, 2)
    assert kernels.flash_layout_ok(q) and kernels.flash_layout_ok(v)
    assert kernels.flash_layout_ok(torch.zeros((2, 6, 77, 32)))
    assert not kernels.flash_layout_ok(torch.zeros((2, 6, 64, 77)).transpose(2, 3))
    padded_rows = torch.zeros((2, 77, 6 * 32 + 4))[..., : 6 * 32]
    assert not kernels.flash_layout_ok(padded_rows.view(2, 77, 6, 32).transpose(1, 2))
    assert not kernels.flash_layout_ok(torch.zeros(2 * 6 * 64 * 32 + 1)[1:].view(2, 6, 64, 32))


def test_flash_routing_rule_matches_jax(monkeypatch):
    """Whole-sequence attention takes the kernel exactly where the JAX
    package takes its Pallas kernel (models/layers.py::_use_flash)."""
    from vision_compression_project_tpu.models import layers as jlayers
    from vision_compression_project_tpu_torch.models import layers as tlayers

    monkeypatch.delenv("VCP_FORCE_XLA_ATTENTION", raising=False)
    for s in (1, 8, 64, 127, 128, 129, 256, 768, 1088):
        for d in (4, 8, 12, 16, 30, 32, 64, 128):
            assert tlayers.use_flash(s, d) == jlayers._use_flash(s, d), (s, d)
