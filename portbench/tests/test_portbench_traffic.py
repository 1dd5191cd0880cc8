"""Seeded traffic: the same seed gives the same requests, another seed other
token ids over the same lengths in the same order."""
import itertools
import json
import os

import numpy as np
import pytest

from portbench import traffic

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def mix(name):
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ["chat32", "rag16"])
def test_same_seed_same_requests(name):
    m = mix(name)
    a = list(itertools.islice(traffic.requests(m, 32768, 2**31 + 7), 100))
    b = list(itertools.islice(traffic.requests(m, 32768, 2**31 + 7), 100))
    assert all(np.array_equal(x.prompt, y.prompt) and x.max_new == y.max_new for x, y in zip(a, b))


@pytest.mark.parametrize("name", ["chat32", "rag16"])
def test_other_seed_same_lengths_other_ids(name):
    m = mix(name)
    g = m["grid"]
    a = list(itertools.islice(traffic.requests(m, 32768, 5), 3 * g))
    b = list(itertools.islice(traffic.requests(m, 32768, 2**31 + 6), 3 * g))
    # each block of `grid` requests holds the grid's (prompt, output) pairs,
    # the blocks in different orders, the same for both seeds
    la = [(len(r.prompt), r.max_new) for r in a]
    for k in range(3):
        assert sorted(la[k * g:(k + 1) * g]) == sorted(traffic.grid(m))
    assert la[:g] != la[g:2 * g]
    assert la == [(len(r.prompt), r.max_new) for r in b]
    assert not np.array_equal(a[0].prompt[:16], b[0].prompt[:16])
    wa, wb = traffic.warm_requests(m, 32768, 5), traffic.warm_requests(m, 32768, 2**31 + 6)
    assert [(len(r.prompt), r.max_new) for r in wa] == [(len(r.prompt), r.max_new) for r in wb]
    assert not np.array_equal(wa[0].prompt[:16], wb[0].prompt[:16])


@pytest.mark.parametrize("name", ["chat32", "rag16"])
def test_lengths_follow_the_mix(name):
    m = mix(name)
    pairs = traffic.grid(m)
    p = [a for a, _ in pairs]
    o = [b for _, b in pairs]
    assert min(p) >= m["prompt"]["min"] and max(p) <= m["prompt"]["max"]
    assert min(o) >= m["output"]["min"] and max(o) <= m["output"]["max"]
    assert abs(np.median(p) - m["prompt"]["median"]) <= 0.1 * m["prompt"]["median"]
    assert abs(np.median(o) - m["output"]["median"]) <= 0.1 * m["output"]["median"]
    # no request outgrows a slot
    assert max(p) + max(o) < m["max_len"]


def test_ids_inside_the_vocabulary_for_any_seed():
    m = mix("chat32")
    for seed in (0, 1, 2**31 + 1, 2**64 + 3, -5):
        r = next(traffic.requests(m, 125696, seed))
        assert r.prompt.min() >= 0 and r.prompt.max() < 125696
    b = next(traffic.batches(mix("ppl2048"), 125696, 2**33))
    assert b.shape == (1, 2048) and b.max() < 125696


def test_warm_requests_finish_at_spread_steps():
    m = mix("chat32")
    w = traffic.warm_requests(m, 32768, 9)
    assert len(w) == m["clients"]
    outs = [r.max_new for r in w]
    assert outs == sorted(outs) and outs[-1] == m["output"]["median"] and outs[0] >= 1
