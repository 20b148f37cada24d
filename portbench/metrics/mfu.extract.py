"""mfu.extract: model FLOPs of the window's extraction batches (encode,
prefill of the real prompt positions, and the decode steps each row took up
to its EOS; yardstick/flops.py) over the batches' host-clock time, each
ending synchronised, and the card's peak for the configuration's dtype, in %."""

from portbench.yardstick.peaks import peak_flops


def read(ctx):
    units = ctx.window["units"]
    seconds = sum(u["seconds"] for u in units)
    if not units or seconds <= 0:
        return None
    return 100.0 * sum(u["flops"] for u in units) / seconds / peak_flops(ctx.cfg["decoder"]["dtype"])
