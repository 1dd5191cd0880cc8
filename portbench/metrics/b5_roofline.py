"""b5_roofline: % of its roofline that the batched whole-model decode kernel
(`batch_kernel`) reaches over the traced window: the summed bound of every
launch (the decoder's weights once, each row's live int8 K/V, over 3.35 TB/s)
over the launches' summed device time."""
from portbench import readers


def read(run):
    return readers.batch_kernel_share(run)
