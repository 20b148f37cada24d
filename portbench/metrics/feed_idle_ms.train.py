"""feed_idle_ms.train: device idle milliseconds a traced training step while
the host was inside the program's `train.feed` range
(train/data.py::device_batch: the pages' host-to-device copy and
preprocess_pages)."""

from portbench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "train.feed")
