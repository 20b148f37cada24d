"""moe_experts_roofline.train: the least time of a step's expert products at
the card's peak for the configuration's dtype (yardstick/lfm2_flops.py
expert_flops: the T * k routed pairs of every MoE layer, 3 products of
2 * dim * moe_dim each, 3x for the forward and the backward) over the
device time of the operations launched inside the program's `moe.experts`
ranges (the forward's and the remat recompute's products, the recompute
counted as time and not as work) and `moe.experts.backward` ranges, in %."""

from portbench.metrics._common import roofline_percent
from portbench.yardstick.lfm2_flops import expert_flops
from portbench.yardstick.peaks import peak_flops


def read(ctx):
    cfg, t = ctx.cfg, ctx.traffic
    seconds = ctx.trace.span_device_s("moe.experts") + ctx.trace.span_device_s("moe.experts.backward")
    bound_ms = 1e3 * expert_flops(cfg, t["batch"], t["text_len"]) / peak_flops(cfg["decoder"]["dtype"])
    return roofline_percent(bound_ms * ctx.trace_units, seconds)
