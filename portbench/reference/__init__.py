"""The plain reference of the cells: the page reader's forward, its loss and
gradients, optax's AdamW and the extraction task's logit mask, in plain
PyTorch from the configuration, the benchmark's weights and its inputs. It
imports neither JAX nor any module of the JAX package or of the port, and
reads no state that the port made: only raw files that both read (the BPE
merges). It runs in float32 with TF32 off (`exact_float32`); a `Precision`
with `low=True` computes it a step below the configuration's precision, the
control that the comparison must fail."""
