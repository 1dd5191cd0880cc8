"""Percentiles over all samples, rates over the whole window, idle shares
from the union of overlapping intervals, on synthetic timestamps."""
import pytest

from portbench import readers, stats
from portbench.harness import Run
from portbench.trace import Trace, short_name


def synthetic_run():
    """Two requests decoding every 10 ms over a 1 s window, with one stall of
    200 ms after the first 50 tokens (a long prefill in the way)."""
    class Rec:
        def __init__(self, sent, times):
            self.sent, self.times = sent, times

    ts = [0.01 * i for i in range(50)] + [0.49 + 0.2 + 0.01 * i for i in range(1, 31)]
    run = Run(cell={}, cfg={}, mix={}, limits={}, seed=0, seconds=1.0, trace=False,
              device="cpu", t_start=-5.0)
    run.t0, run.t1 = 0.0, 1.0
    run.requests = [Rec(0.0, list(ts)), Rec(-0.5, [-0.4] + list(ts))]
    return run, ts


def test_itl_tail_holds_the_stall():
    run, ts = synthetic_run()
    gaps = readers.itl_ms(run)
    # every gap of both requests, both ends inside the window (the second
    # request's first token came before it)
    assert len(gaps) == 2 * (len(ts) - 1)
    assert stats.percentile(gaps, 100) == pytest.approx(210.0)
    assert stats.percentile(gaps, 50) == pytest.approx(10.0)
    # one stall in 79 gaps a request: the 99th percentile sees it, the 95th not
    assert stats.percentile(gaps, 99) > 50 and stats.percentile(gaps, 95) == pytest.approx(10.0)


def test_rate_over_the_whole_window():
    run, ts = synthetic_run()
    assert readers.output_tokens(run) == 2 * len(ts)
    assert readers.window_s(run) == 1.0
    # a median of chunks would hide the stall; the rate over the window does not
    assert readers.output_tokens(run) / readers.window_s(run) == pytest.approx(160.0)


def test_ttft_counts_requests_sent_in_the_window():
    run, _ = synthetic_run()
    assert readers.ttft_ms(run) == [pytest.approx(0.0)]


def test_percentile_is_over_every_sample():
    v = list(range(1, 101))
    assert stats.percentile(v, 90) == pytest.approx(90.1)
    assert stats.percentile([], 90) is None


def test_union_counts_overlaps_once():
    iv = [(0.0, 1.0), (0.5, 1.5), (2.0, 3.0), (2.2, 2.4), (5.0, 5.0)]
    assert stats.union_seconds(iv) == pytest.approx(2.5)
    assert stats.gaps(iv, 0.0, 6.0) == [(1.5, 2.0), (3.0, 5.0), (5.0, 6.0)]


def test_idle_share_from_the_trace():
    tr = Trace(kernels=[("void batch_kernel<4>(BatchArgs)", 0.0, 0.4), ("a", 0.3, 0.5),
                        ("b", 0.8, 0.9)], t0=0.0, t1=1.0)
    run, _ = synthetic_run()
    run.device_trace = tr
    assert tr.busy_s() == pytest.approx(0.6)
    assert readers.idle_share(run) == pytest.approx(40.0)
    assert tr.count(readers.BATCH_KERNEL) == 1
    gaps = dict(tr.idle_gaps([("step", 0.45, 0.9)]))
    assert gaps["step"] == pytest.approx(0.3) and gaps["between calls"] == pytest.approx(0.1)


def test_short_names():
    assert short_name("void batch_kernel<4, (Mode)1>(BatchArgs)") == "batch_kernel"
    assert short_name("void mlp_mma_kernel<Cfg<128, 128>, true>(MlpMmaArgs)") == "mlp_mma_kernel"
    assert short_name("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert short_name("void (anonymous namespace)::batch_kernel<4, true>(BatchArgs)") == \
        "batch_kernel"
    assert short_name("void at::native::(anonymous namespace)::vectorized_elementwise_kernel"
                      "<4, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >"
                      "(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)") == \
        "at::native::vectorized_elementwise_kernel"
