"""k1_bwd_roofline.train: the least time of a step's attention backward calls
(yardstick/attention.py backward_bound_ms) over the device time of K1's
backward kernels (Delta, dK/dV and dQ passes) in the traced steps, in %."""

from portbench.metrics._common import K1_BWD, roofline_percent
from portbench.yardstick.attention import kernel_calls, total_bound_ms
from portbench.yardstick.flops import train_attention_calls


def read(ctx):
    t = ctx.traffic
    calls = kernel_calls(train_attention_calls(ctx.cfg, t["batch"], t["text_len"]))
    bound = total_bound_ms(calls, ctx.cfg["decoder"]["dtype"], backward=True) * ctx.trace_units
    return roofline_percent(bound, ctx.trace.kernel_s(K1_BWD))
