"""``kv_restore_layers``' share of its roofline in the traced slice: the
bound time of every chunk the fetches restored (uint8 frames read, fp32
rows written) over the device time of its kernel, in %."""
from kvbench import flops, readers


def _calls(run, steps):
    m = run.model
    chunks = [c for s in steps for n in s.fetches
              for c in run.restore_chunks[n]]
    return len(chunks), sum(flops.kv_restore_bound_s(m, g, n)
                            for g, n in chunks)


def read(run):
    return readers.roofline(run, "kv_restore_kernel", ("kv_restore_kernel",),
                            _calls)
