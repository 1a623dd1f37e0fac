"""95th percentile, over the plain requests admitted in the window, of
``Request.t_admitted`` to the start of the request's ``plain prefill``
span: the wait behind the other prefills and fetches of its step."""
from kvbench import program_spans, readers


def read(run):
    return readers.p(program_spans.prefill_waits(run), 95)
