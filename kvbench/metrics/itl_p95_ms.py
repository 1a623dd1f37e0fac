"""95th percentile of every gap between consecutive output tokens of
every request, both tokens in the window."""
from kvbench import readers, stats


def read(run):
    return readers.p(stats.gaps(run.records, run.window), 95, 1e3)
