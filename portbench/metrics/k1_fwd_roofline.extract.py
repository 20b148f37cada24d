"""k1_fwd_roofline.extract: the least time of an extraction batch's
whole-sequence attention calls (the encoder's and the prefill's;
yardstick/attention.py bound_ms) over the device time of K1's forward
kernels in the traced batch, in %."""

from portbench.metrics._common import K1_FWD, roofline_percent
from portbench.yardstick.attention import kernel_calls, total_bound_ms
from portbench.yardstick.flops import extract_attention_calls


def read(ctx):
    calls = kernel_calls(extract_attention_calls(ctx.cfg, ctx.traffic["batch"]))
    bound = total_bound_ms(calls, ctx.cfg["decoder"]["dtype"]) * ctx.trace_units
    return roofline_percent(bound, ctx.trace.kernel_s(K1_FWD))
