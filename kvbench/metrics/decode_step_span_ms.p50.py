"""Median host time of the program's ``decode step`` spans in the window
(``decode_paged`` to the tokens' readback), in any step, whether or not
a prefill shared it."""
from kvbench import program_spans, readers


def read(run):
    return readers.p([s.seconds for s in program_spans.inside(
        run, "decode step")], 50, 1e3)
