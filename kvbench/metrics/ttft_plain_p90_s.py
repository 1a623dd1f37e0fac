"""90th percentile of the time to first token, from the due time, of
every plain request whose first token falls in the window."""
from kvbench import readers, stats


def read(run):
    return readers.p(stats.ttfts(run.records, run.window, reuse=False), 90)
