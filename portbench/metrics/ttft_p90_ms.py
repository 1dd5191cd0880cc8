"""ttft_p90_ms: the 90th percentile, over every request sent inside the window,
of the time from its sending to its first token at the client (host clock)."""
from portbench import readers, stats


def read(run):
    return stats.percentile(readers.ttft_ms(run), 90)
