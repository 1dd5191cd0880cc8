"""step_ms_p50: the median of the harness's spans around each
`PagedMegaBatcher.step()` in the window (the waves of the batched kernel,
the lm_head, the argmax pulled), ms on the host clock."""
from portbench import readers


def read(run):
    return readers.span_p50_ms(run, "step")
