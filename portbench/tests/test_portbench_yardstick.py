"""The FLOP and bound counters against hand counts at small shapes."""

import math

import pytest

from portbench.yardstick import attention as att
from portbench.yardstick import flops
from portbench.yardstick.peaks import HBM_BYTES_PER_S, PEAK_FLOPS


def small_cfg(experts=0):
    return {"vision": {"image_size": 64, "patch": 16, "dim_local": 8, "dim_global": 16, "depth_local": 1,
                       "depth_global": 1, "heads_local": 2, "heads_global": 2, "window": 2, "downsample": 2,
                       "dtype": "bfloat16"},
            "decoder": {"vocab": 10, "dim": 4, "depth": 1, "heads": 2, "kv_heads": 1, "head_dim": 2,
                        "mlp_ratio": 2.0, "num_experts": experts, "expert_every": 1, "dtype": "bfloat16"}}


def test_bound_causal_by_hand():
    sh = att.AttnShape("x", 1, 2, 1, 4, 8, True, (3,), 1)
    # pairs per head: rows 0..3 see min(row + 1, 3) keys = 1 + 2 + 3 + 3 = 9
    ops = 4 * 8 * 9 * 2
    nbytes = (2 * 1 * 2 + 2 * 1 * 1) * 4 * 8 * 2 + 4
    want = max(ops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S) * 1e3
    got, which = att.bound_ms(sh, "bfloat16")
    assert math.isclose(got, want) and which == "bytes"


def test_backward_bound_by_hand():
    sh = att.AttnShape("x", 2, 4, 2, 8, 16, False, (8, 5), 1)
    pairs = (8 + 5) * 8
    ops = 10 * 16 * pairs * 4
    nbytes = (4 * 2 * 4 + 4 * 2 * 2) * 8 * 16 * 2 + 4 * 2 * 4 * 8 + 4 * 2
    want = max(ops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S) * 1e3
    assert math.isclose(att.backward_bound_ms(sh, "bfloat16")[0], want)


def test_kernel_calls_follow_the_ports_rule():
    calls = att.encoder_calls(small_cfg(), 3)
    assert [c.s for c in calls] == [4, 4] and att.kernel_calls(calls) == []
    big = att.AttnShape("x", 1, 1, 1, 128, 64, False, (128,), 1)
    assert att.kernel_calls([big]) == [big]


def test_encode_flops_by_hand():
    cfg = small_cfg()
    # grid 4 (16 patches), patch_dim 768, windows of 2x2 (4 windows of 4 tokens), 4 global tokens
    patch = 2 * 16 * 768 * 8
    local = 32 * 16 * 8 * 8 + 4 * 8 * 16 * 4
    conv = 2 * 4 * (8 * 4) * 16
    glob = 32 * 4 * 16 * 16 + 4 * 16 * 4 * 4
    proj = 2 * 4 * 16 * 4
    assert flops.encode_flops(cfg) == patch + local + conv + glob + proj


@pytest.mark.parametrize("experts", [0, 3])
def test_train_step_flops_by_hand(experts):
    cfg = small_cfg(experts)
    s = 4 + 6 - 1                      # vision tokens + text_len - 1
    attn_mats = 2 * 4 * 2 * (2 * 2 + 2 * 1)
    ffn = 2 * 3 * 4 * 8 + (2 * 4 * experts if experts else 0)
    attn = 4 * 2 * 2 * s * (s + 1) // 2
    unembed = 2 * 4 * 10 * (6 - 1)
    per_row = flops.encode_flops(cfg) + s * (attn_mats + ffn) + attn + unembed
    assert flops.train_step_flops(cfg, 2, 6) == 3 * 2 * per_row


def test_extract_batch_flops_by_hand():
    cfg = small_cfg()
    p = 4 + 2
    tok = 2 * 4 * 2 * (2 * 2 + 2 * 1) + 2 * 3 * 4 * 8
    row = flops.encode_flops(cfg) + p * tok + 4 * 2 * 2 * p * (p + 1) // 2 + 2 * 4 * 10
    # three tokens served: two decode steps feeding positions 6 and 7, attending to 7 and 8 keys
    row += 2 * (tok + 2 * 4 * 10) + 4 * 2 * 2 * (7 + 8)
    assert flops.extract_batch_flops(cfg, [3, 1]) == row + (flops.encode_flops(cfg) + p * tok
                                                            + 4 * 2 * 2 * p * (p + 1) // 2 + 2 * 4 * 10)


def test_prompt_bucket():
    assert flops.prompt_bucket(2) == 64 and flops.prompt_bucket(65) == 128
