"""One general generator for every traffic mix: a mix is a data file.

Serving mixes (`kind` "paged_serve") draw prompt and output lengths from
lognormal distributions clipped to a range. So that every seed does the same
work, the lengths are a fixed grid of `grid` (prompt, output) pairs taken at
evenly spaced quantiles, paired in a fixed order, and sent block after block
of `grid` requests, each block shuffled in an order that is the same for
every seed: a fixed trace of lengths. The seed draws the prompts' token ids
(and, elsewhere, the weights). In a closed loop the order of the lengths
decides which requests finish in the same step and which prompts fall in the
window, so seeds that only reordered the same lengths did different work:
the 95th percentile of the gaps between tokens read 259-314 ms over six
seeds of one cell on an H100.

Evaluation mixes (`kind` "ppl_eval") are batches of `seq_len` token ids.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist
from typing import Iterator, List, Tuple

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for (seed, stream...): any whole seed, also one past
    64 bits or below 0."""
    s = int(seed)
    return np.random.default_rng([s & (2**64 - 1), (s >> 64) & (2**64 - 1), int(s < 0), *stream])


def lengths(spec: dict, n: int) -> List[int]:
    """n lengths at the quantiles (i + 0.5) / n of a lognormal with the
    spec's median and sigma, rounded and clipped to [min, max]."""
    nd = NormalDist()
    out = []
    for i in range(n):
        z = nd.inv_cdf((i + 0.5) / n)
        v = int(round(spec["median"] * math.exp(spec["sigma"] * z)))
        out.append(min(max(v, spec["min"]), spec["max"]))
    return out


def grid(mix: dict) -> List[Tuple[int, int]]:
    """The mix's (prompt length, output length) pairs, in a fixed pairing
    that does not depend on the seed."""
    g = mix["grid"]
    prompts = lengths(mix["prompt"], g)
    outs = lengths(mix["output"], g)
    pair = np.random.default_rng(0).permutation(g)
    return [(prompts[i], outs[int(pair[i])]) for i in range(g)]


@dataclass
class Req:
    prompt: np.ndarray      # int64 token ids
    max_new: int


def requests(mix: dict, vocab: int, seed: int) -> Iterator[Req]:
    """The endless stream of requests of a serving mix under `seed`: the
    lengths in the same order for every seed, the token ids from the seed."""
    pairs = grid(mix)
    order, ids = rng(0, 1), rng(seed, 1)
    while True:
        for i in order.permutation(len(pairs)):
            n, out = pairs[int(i)]
            yield Req(ids.integers(0, vocab, size=n, dtype=np.int64), out)


def warm_requests(mix: dict, vocab: int, seed: int) -> List[Req]:
    """One request a client that starts the loop before the window: prompts
    from the grid, outputs cut so that the clients finish at evenly spread
    steps (1 .. the median output), as they would in a loop already running."""
    pairs = grid(mix)
    order, ids = rng(0, 2), rng(seed, 2)
    n = mix["clients"]
    med = mix["output"]["median"]
    out = []
    for c, i in enumerate(order.permutation(len(pairs))[:n] if n <= len(pairs)
                          else order.integers(0, len(pairs), n)):
        p = pairs[int(i)][0]
        out.append(Req(ids.integers(0, vocab, size=p, dtype=np.int64),
                       max(1, -(-(c + 1) * med // n))))
    return out


def batches(mix: dict, vocab: int, seed: int) -> Iterator[np.ndarray]:
    """The endless stream of [batch, seq_len] token-id batches of an
    evaluation mix."""
    r = rng(seed, 3)
    while True:
        yield r.integers(0, vocab, size=(mix["batch"], mix["seq_len"]), dtype=np.int64)
