"""Training: the optimizer and the train step (counterpart of ``repro/train``)."""
