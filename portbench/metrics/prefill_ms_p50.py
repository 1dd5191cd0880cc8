"""prefill_ms_p50: the median of the harness's spans around each admitting
`PagedMegaBatcher.add_request` in the window (engine.prefill, the pages
scattered, the first token pulled), ms on the host clock."""
from portbench import readers


def read(run):
    return readers.span_p50_ms(run, "prefill")
