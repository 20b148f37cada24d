"""Tests of the port that need the card: the hand-written kernels against
their plain versions on CUDA tensors. They skip without a CUDA device.

This file imports nothing of JAX, so it also runs where JAX is not
installed. On the GPU machine, from the repository root:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import dataclasses

import pytest
import torch

from vision_compression_project_tpu_torch import kernels
from vision_compression_project_tpu_torch.models import VLMRunner, get_preset
from vision_compression_project_tpu_torch.models.tokenizer import BOS_ID, TASK_EXTRACT_ID
from vision_compression_project_tpu_torch.ops.attention import flash_attention, mha_reference

pytestmark = pytest.mark.gpu

TOL = {torch.bfloat16: 1e-2, torch.float32: 2e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b,h,hkv,s,d,kv_len,causal",
    [
        (2, 4, 4, 256, 64, None, False),
        (2, 4, 4, 256, 64, None, True),
        (2, 8, 2, 128, 32, [128, 57], False),
        (3, 6, 2, 200, 64, [200, 0, 37], True),
        (2, 6, 2, 1088, 64, [1026, 1087], True),
        (1, 2, 1, 5, 32, [3], True),
    ],
)
def test_kernel_matches_plain(cuda, dtype, b, h, hkv, s, d, kv_len, causal):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, h, s, d), generator=g, device=cuda).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=g, device=cuda).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=g, device=cuda).to(dtype)
    kv = None if kv_len is None else torch.tensor(kv_len, dtype=torch.int32, device=cuda)
    before = kernels.launches["flash_attention"]
    got = flash_attention(q, k, v, kv_len=kv, causal=causal)
    torch.cuda.synchronize()
    assert kernels.launches["flash_attention"] == before + 1
    want = mha_reference(q, k, v, kv_len=kv, causal=causal)
    assert got.dtype == dtype and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


def test_kernel_refuses_unsupported_head_dim(cuda):
    q = torch.zeros((1, 2, 128, 48), device=cuda)
    before = dict(kernels.launches)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q)
    assert kernels.launches == before


def test_runner_first_logits_card_vs_cpu(cuda):
    cfg = get_preset("tiny")
    cfg = dataclasses.replace(
        cfg, vision=dataclasses.replace(cfg.vision, dtype="float32"),
        decoder=dataclasses.replace(cfg.decoder, dtype="float32"),
    )
    page = torch.randint(0, 256, (1, 90, 70), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(0)).numpy()
    out = []
    for device in (cuda, "cpu"):
        runner = VLMRunner(cfg, seed=0, device=device)
        vis = runner.encode(runner.preprocess_patches(page))
        ids, lens = runner.pad_prompts([[BOS_ID, TASK_EXTRACT_ID]])
        logits, _, _ = runner.first_logits(ids, lens, vis, 128)
        out.append(logits.cpu())
    assert (out[0] - out[1]).abs().max().item() <= 1e-3
