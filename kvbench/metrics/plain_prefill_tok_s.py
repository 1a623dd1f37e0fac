"""Prompt tokens over host time of the plain requests' ``plain prefill``
spans (the program's own, each to its first token's readback) that end
in the window."""
from kvbench import program_spans


def read(run):
    spans = program_spans.plain_prefills(run)
    if not spans:
        return None
    return (sum(s.counts["tokens"] for s in spans)
            / sum(s.seconds for s in spans))
