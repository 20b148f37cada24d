"""backward_idle_ms.train: device idle milliseconds a traced training step
while the host was inside the program's `train.backward` range (train_step:
loss.backward() with the remat recompute, and on a mesh the gradients' sum)."""

from portbench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "train.backward")
