"""optimizer_idle_ms.train: device idle milliseconds a traced training step
while the host was inside the program's `train.optimizer` range
(train_step.AdamW.update: the clip's norms and the _foreach passes)."""

from portbench.metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "train.optimizer")
