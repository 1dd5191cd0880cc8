"""idle_share.<part> (`idle_share.decode`, `.prefill`, `.ppl`): % of the
traced window in which no operation ran on the device (the union of the
device's operation intervals, from torch.profiler)."""
from portbench import readers


def read(run):
    return readers.idle_share(run)
