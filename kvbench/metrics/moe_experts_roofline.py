"""The grouped expert kernels' share of their roofline in the traced
slice: over every MoE layer call in it (the program's ``moe`` spans, with
their ``tokens``, ``choices`` and ``experts``), the sum of its gate-up
and down launches' bounds (``moe_bound.py``) over the device time of
those launches, in %.  Nothing to read where the program records no
``moe`` span."""
from kvbench import moe_bound, program_spans, readers

ONCE = "moe_sort_kernel"  # one launch a layer call
PRODUCTS = ("moe_skinny_kernel", "moe_tiled_kernel")


def _calls(run, steps):
    tr = program_spans.tracer()
    lo, hi = run.trace.host
    spans = tr.spans("moe", lo, hi) if tr is not None else None
    spans = [s for s in spans or () if s.t0 >= lo]
    if not spans or any("experts" not in s.counts for s in spans):
        return 0, 0.0
    return len(spans), sum(
        moe_bound.layer_bound_s(run.model, s.counts["tokens"],
                                s.counts["choices"], s.counts["experts"])
        for s in spans)


def read(run):
    return readers.roofline(run, ONCE, PRODUCTS, _calls)
