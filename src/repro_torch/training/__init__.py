"""Training: the data stream (a numpy copy of the reference's), AdamW,
checkpoints and the train loop, on torch tensors."""
