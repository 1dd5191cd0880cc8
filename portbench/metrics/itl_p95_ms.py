"""itl_p95_ms: the 95th percentile of every gap between two consecutive output
tokens of a request, both inside the window (host clock). A prefill that
stalls the batch lands in the tail."""
from portbench import readers, stats


def read(run):
    return stats.percentile(readers.itl_ms(run), 95)
