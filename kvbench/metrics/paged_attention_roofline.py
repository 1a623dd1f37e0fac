"""``paged_attention``'s share of its roofline in the traced slice: the
bound time of every call the decode steps made (one per layer, over the
batch's contexts; bytes of fp32 pages read once) over the device time of
its split and merge kernels, in %."""
from kvbench import flops, readers


def _calls(run, steps):
    m, ps = run.model, run.engine["page_size"]
    dec = [s for s in steps if s.decodes]
    bound = sum(m["num_layers"] * flops.paged_attention_bound_s(m, s.decodes,
                                                                ps)
                for s in dec)
    return m["num_layers"] * len(dec), bound


def read(run):
    return readers.roofline(run, "paged_attention_split_kernel",
                            ("paged_attention_split_kernel",
                             "paged_attention_merge_kernel"), _calls)
