"""ms_per_decode_step.extract: the host clock around each synchronised
extraction batch of the window, summed, over the decode steps the batches
took (counted from the returned tokens), in ms. Encode and prefill are
amortised into it."""


def read(ctx):
    units = ctx.window["units"]
    steps = sum(u["decode_steps"] for u in units)
    return None if steps == 0 else 1e3 * sum(u["seconds"] for u in units) / steps
