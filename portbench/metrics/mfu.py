"""mfu.<part> (`mfu.decode`, `mfu.prefill`, `mfu.ppl`): % of the chip's peak
over the window: the least time the chip could spend on every call of the
window (each step, prefill or loss batch at the larger of its FLOPs over 989
TFLOP/s and its bytes over 3.35 TB/s, counted by portbench/roofline.py from
the shapes) over the window's wall."""
from portbench import readers


def read(run):
    return readers.mfu(run)
