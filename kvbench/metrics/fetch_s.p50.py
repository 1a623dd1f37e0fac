"""Median ``fetch_done - fetch_started`` of the fetches done in the
window: host codec decode and ``kv_restore`` of a whole prefix."""
from kvbench import readers, stats


def read(run):
    return readers.p(stats.fetch_times(run.records, run.window), 50)
