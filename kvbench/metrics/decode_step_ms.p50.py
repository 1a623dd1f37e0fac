"""Median host time of the ``LiveEngine.step()`` calls in the window that
only decoded (no prefill, no fetch); each ends by reading its tokens
back, a device sync."""
from kvbench import readers


def read(run):
    return readers.p([s.t1 - s.t0 for s in readers.window_steps(run)
                      if s.decode_only], 50, 1e3)
