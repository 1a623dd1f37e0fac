"""Median time to first token, from the due time, of every reuse request
whose first token falls in the window."""
from kvbench import readers, stats


def read(run):
    return readers.p(stats.ttfts(run.records, run.window, reuse=True), 50)
