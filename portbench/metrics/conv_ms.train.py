"""conv_ms.train: device milliseconds a traced training step of the
operations launched inside the program's `conv.forward` ranges (ShortConv's
in_proj, gate, taps and out_proj, in the forward and in the remat
recompute) and `conv.backward` ranges (its backward)."""

from portbench.metrics._spans import launched_ms


def read(ctx):
    return launched_ms(ctx, ("conv.forward", "conv.backward"))
