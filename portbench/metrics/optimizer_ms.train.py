"""optimizer_ms.train: device milliseconds a step of the operations launched
inside the benchmark's span around the optimizer's update (AdamW.update:
the clip's norms and the _foreach passes), in the traced steps."""


def read(ctx):
    seconds = ctx.trace.span_device_s("portbench.optimizer")
    return None if seconds <= 0 else 1e3 * seconds / ctx.trace_units
