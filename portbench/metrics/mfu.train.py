"""mfu.train: model FLOPs of the window's training steps (yardstick/flops.py:
products 2mnk, attention 4D a pair, 3x the forward, no recompute) over the
window's time and the card's peak for the configuration's dtype, in %."""

from portbench.yardstick.peaks import peak_flops


def read(ctx):
    w = ctx.window
    if w["steps"] == 0:
        return None
    return 100.0 * w["step_flops"] * w["steps"] / w["seconds"] / peak_flops(ctx.cfg["decoder"]["dtype"])
