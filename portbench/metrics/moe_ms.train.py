"""moe_ms.train: device milliseconds a traced training step of the
operations launched inside the program's `moe.forward` ranges (Switch-MoE's
forward: router, routing, experts and combine, in the forward and in the
remat recompute) and `moe.backward` ranges (its backward)."""

from portbench.metrics._spans import launched_ms


def read(ctx):
    return launched_ms(ctx, ("moe.forward", "moe.backward"))
