"""Share of the traced slice's wall time in which no operation ran on the
device (1 - union of device records / slice), in %."""
from kvbench import readers


def read(run):
    return readers.idle_share(run)
