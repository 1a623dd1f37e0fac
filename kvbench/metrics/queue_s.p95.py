"""95th percentile of the wait from due time to admission
(``Request.t_admitted``) of every plain request admitted in the window."""
from kvbench import readers, stats


def read(run):
    return readers.p(stats.queue_waits(run.records, run.window,
                                       reuse=False), 95)
