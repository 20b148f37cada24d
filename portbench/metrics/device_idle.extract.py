"""device_idle.extract: the share of the traced extraction batch's window in
which no operation ran on the device (the union of the profiler's device
intervals), in %."""

from portbench.metrics._common import idle_percent


def read(ctx):
    return idle_percent(ctx)
