"""ppl_tokens_per_s: tokens scored (their losses summed) inside the window over
the window's seconds (host clock)."""
from portbench import readers


def read(run):
    if not run.scored:
        return None
    return sum(n for n, t in run.scored if run.in_window(t)) / readers.window_s(run)
