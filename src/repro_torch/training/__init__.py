"""Training: AdamW, the train step over the model zoo, the loop and
checkpoints (counterpart of ``repro/training``)."""
