"""Model operations of every prefill and decode token in the traced slice
over its wall time x 67 TFLOP/s (H100 SXM fp32 outside the tensor cores,
as the port runs with TF32 off), in %."""
from kvbench import readers


def read(run):
    return readers.model_mfu(run)
