"""Median, over the fetches done in the window, of the host time of a
fetch's ``codec decode`` spans (the program's own): each chunk's rANS
decode, frame reconstruction and copy into the staging buffer."""
from kvbench import program_spans, readers


def read(run):
    return readers.p(program_spans.per_fetch(run, "codec decode",
                                             lambda s: s.seconds), 50)
