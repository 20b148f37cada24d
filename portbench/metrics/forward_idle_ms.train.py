"""forward_idle_ms.train: device idle milliseconds a traced training step while
the host was inside the program's `train.forward` range
(train/train_step.py::train_step: the gradients' reset and vlm_loss, the
remat'd forward)."""

from portbench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "train.forward")
