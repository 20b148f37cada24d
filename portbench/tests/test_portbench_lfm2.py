"""The LFM2 cell's pieces: its spec, the metrics it is and is not listed
in, its FLOP count against a hand count at a tiny size, and the readers of
its two new metrics on traces with and without the program's ranges."""

import json
import types

import pytest
import torch

from portbench import spec, weights_lfm2
from portbench.tracing import Traced
from portbench.yardstick import flops, lfm2_flops
from portbench.yardstick.peaks import PEAK_FLOPS

CELL = "lfm2_24b_a2b.train_mixc_b32_lfm2"
MS = 1_000_000  # ns


def test_the_cell_loads():
    cell = spec.find_cell(CELL)
    assert cell.traffic["kind"] == "train_lfm2" and cell.chips == 1
    assert {m["name"] for m in cell.end_to_end} == {"train_pages_per_s", "setup_s"}
    names = {m["name"] for m in cell.per_layer}
    assert {"mfu.train", "optimizer_ms.train", "moe_ms.train", "conv_ms.train",
            "moe_experts_roofline.train", "device_idle.train"} <= names
    assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    d = cell.config["decoder"]
    assert (d["dim"], d["heads"], d["kv_heads"], d["head_dim"], d["moe_dim"], d["num_experts"],
            d["experts_per_token"]) == (2048, 32, 8, 64, 1536, 64, 4)
    assert int(d["dim"] * d["mlp_ratio"]) == cell.config["intermediate_size"] == 11776


def test_the_cell_is_in_no_k1_roofline():
    """K1's readers count `decoder.depth` attention calls; 2 of this
    configuration's 10 layers attend, so they would read past 100%."""
    cell = spec.find_cell(CELL)
    names = {m["name"] for m in cell.per_layer}
    assert not {n for n in names if n.startswith("k1_")}


def test_the_config_keeps_the_catalog_numbers():
    """Every key of the published config is there, changed only where
    `reduced` says; the decoder the port builds is the file's."""
    cfg = spec.find_cell(CELL).config
    bench = {c["name"]: c for c in spec.load_benchmark()["configs"]}["lfm2_24b_a2b"]
    assert bench["reduced"] == cfg["reduced"]
    d = cfg["decoder"]
    assert cfg["num_hidden_layers"] == d["depth"] == len(d["layer_types"]) == len(cfg["layer_types"])
    assert cfg["layer_types"] == d["layer_types"] and cfg["vocab_size"] == d["vocab"]
    assert (cfg["hidden_size"], cfg["moe_intermediate_size"], cfg["num_experts"], cfg["num_experts_per_tok"],
            cfg["num_key_value_heads"], cfg["num_attention_heads"], cfg["num_dense_layers"], cfg["conv_L_cache"],
            cfg["norm_eps"]) == (d["dim"], d["moe_dim"], d["num_experts"], d["experts_per_token"], d["kv_heads"],
                                 d["heads"], d["num_dense_layers"], d["conv_kernel"], d["norm_eps"])
    assert cfg["rope_parameters"]["rope_theta"] == d["rope_theta"]
    assert cfg["cut"] == {"decoder.depth": [40, 10], "decoder.vocab": [65536, 8192]}


def _tiny():
    return {"vision": {"image_size": 64, "patch": 16, "dim_local": 8, "dim_global": 16, "depth_local": 1,
                       "depth_global": 1, "heads_local": 2, "heads_global": 2, "window": 2, "downsample": 2,
                       "dtype": "bfloat16"},
            "decoder": {"vocab": 10, "dim": 4, "depth": 3, "heads": 2, "kv_heads": 1, "head_dim": 2,
                        "mlp_ratio": 2.0, "num_experts": 3, "expert_every": 1, "dtype": "bfloat16",
                        "layer_types": ["conv", "full_attention", "conv"], "num_dense_layers": 1, "moe_dim": 5,
                        "experts_per_token": 2, "conv_kernel": 3}}


def test_train_step_flops_by_hand():
    cfg = _tiny()
    s = 4 + 6 - 1                                          # vision tokens + text_len - 1
    conv = 2 * 4 * 12 + 2 * 3 * 4 + 2 * 4 * 4             # in_proj, taps, out_proj
    attn_mats = 2 * 4 * 2 * (2 * 2 + 2 * 1)
    dense = 2 * 3 * 4 * 8
    moe = 2 * 4 * 3 + 2 * (2 * 3 * 4 * 5)                  # router, two experts
    attn = 4 * 2 * 2 * s * (s + 1) // 2                    # the one attention layer
    unembed = 2 * 4 * 10 * (6 - 1)
    per_row = flops.encode_flops(cfg) + s * (conv + dense + attn_mats + moe + conv + moe) + attn + unembed
    assert lfm2_flops.train_step_flops(cfg, 2, 6) == 3 * 2 * per_row
    assert lfm2_flops.routed_pairs(cfg, 2, 6) == 2 * s * 2
    assert lfm2_flops.expert_flops(cfg, 2, 6) == 3 * 2 * (2 * s * 2) * 3 * 2 * 4 * 5


def test_the_cells_weights_count():
    cfg = spec.find_cell(CELL).config
    experts = sum(leaf.dtype == "bfloat16" for leaf in weights_lfm2.leaves(cfg))
    assert experts == 3 * 8
    n_expert = sum(int(torch.Size(leaf.shape).numel()) for leaf in weights_lfm2.leaves(cfg) if leaf.dtype == "bfloat16")
    assert n_expert == 8 * 64 * 3 * 2048 * 1536


def _ctx(cfg, traffic, device_ops, host_ops, units=1):
    trace = Traced(torch.device("cpu"))
    trace.device_ops = [(n, s * MS, e * MS, c) for n, s, e, c in device_ops]
    trace.host_ops = [(n, s * MS, e * MS, c) for n, s, e, c in host_ops]
    trace.window = (0, 100 * MS)
    return types.SimpleNamespace(cfg=cfg, traffic=traffic, trace=trace, trace_units=units)


@pytest.mark.parametrize("name", ["conv_ms.train", "moe_experts_roofline.train"])
def test_the_new_readers_give_nothing_without_their_ranges(name):
    """A program without the ranges (the parent's) gives no reading, and
    raises nothing."""
    cell = spec.find_cell(CELL)
    ctx = _ctx(cell.config, cell.traffic, [("k", 0, 10, 1)], [("aten::mm", 0, 5, 0), ("cudaLaunchKernel", 1, 2, 1),
                                                              ("moe.forward", 0, 9, 0)])
    assert spec.metric_reader(name)(ctx) is None


def test_the_readers_by_launch():
    cell = spec.find_cell(CELL)
    host = [("conv.forward", 0, 10, 0), ("cudaLaunchKernel", 1, 2, 1), ("moe.experts", 20, 30, 0),
            ("cuLaunchKernelEx", 21, 22, 2), ("conv.backward", 40, 50, 0), ("cudaLaunchKernel", 41, 42, 3),
            ("moe.experts.backward", 60, 70, 0), ("cudaLaunchKernel", 61, 62, 4), ("cudaLaunchKernel", 80, 81, 5)]
    device = [("a", 2, 6, 1), ("gemm", 22, 32, 2), ("b", 42, 45, 3), ("gemm_bwd", 62, 82, 4), ("c", 82, 99, 5)]
    ctx = _ctx(cell.config, cell.traffic, device, host, units=2)
    assert spec.metric_reader("conv_ms.train")(ctx) == pytest.approx((4 + 3) / 2)
    t = cell.traffic
    bound_s = lfm2_flops.expert_flops(cell.config, t["batch"], t["text_len"]) / PEAK_FLOPS["bfloat16"]
    want = 100.0 * bound_s * 2 / ((10 + 20) * 1e-3)
    assert spec.metric_reader("moe_experts_roofline.train")(ctx) == pytest.approx(want)


def test_the_traffic_is_train_mixc_b32s():
    here = spec.HERE / "traffic"
    mine, theirs = (json.loads((here / f"{n}.json").read_text()) for n in ("train_mixc_b32_lfm2", "train_mixc_b32"))
    assert {k: v for k, v in mine.items() if k not in ("kind", "about")} == \
        {k: v for k, v in theirs.items() if k not in ("kind", "about")}
