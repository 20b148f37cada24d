"""k1_fwd_roofline.train: the least time of a step's attention forward calls
(yardstick/attention.py bound_ms, each call once: what the inputs need, the
recompute not counted) over the device time of K1's forward kernels in the
traced steps, in %."""

from portbench.metrics._common import K1_FWD, roofline_percent
from portbench.yardstick.attention import kernel_calls, total_bound_ms
from portbench.yardstick.flops import train_attention_calls


def read(ctx):
    t = ctx.traffic
    calls = kernel_calls(train_attention_calls(ctx.cfg, t["batch"], t["text_len"]))
    bound = total_bound_ms(calls, ctx.cfg["decoder"]["dtype"]) * ctx.trace_units
    return roofline_percent(bound, ctx.trace.kernel_s(K1_FWD))
