"""Device time of the grouped expert kernels' gate-up and down launches
over the traced slice's busy device time (the union of its device
records), in %."""
PRODUCTS = ("moe_skinny_kernel", "moe_tiled_kernel")


def read(run):
    sl = run.trace
    if sl is None or sl.busy_s <= 0:
        return None
    dev_s, records = sl.kernel_time(*PRODUCTS)
    if records == 0:
        return None
    return 100.0 * dev_s / sl.busy_s
