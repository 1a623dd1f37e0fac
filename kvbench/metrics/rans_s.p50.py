"""Median, over the fetches done in the window, of the host time a
fetch's ``codec decode`` spans spent in the rANS streams' reads (their
``rans_s`` counts, kept by ``KVCodec``)."""
from kvbench import program_spans, readers


def read(run):
    return readers.p(program_spans.per_fetch(run, "codec decode",
                                             lambda s: s.counts["rans_s"]),
                     50)
