"""decode_tokens_per_s: output tokens that reached their clients inside the
window, first tokens included, over the window's seconds (host clock)."""
from portbench import readers


def read(run):
    if not run.requests:
        return None
    return readers.output_tokens(run) / readers.window_s(run)
