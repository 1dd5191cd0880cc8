"""Both drivers run end to end on the CPU through the port's plain paths, at
a tiny size, from a copy of the benchmark with tiny cells added as files and
entries alone; with the timed path broken underneath, `correct` comes out
false."""
import json

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    torch.set_num_threads(1)     # multithreaded bf16 matmuls vary from run to run on the CPU
    return tiny.make_root(tmp_path_factory.mktemp("bench"))


def run(root, cell, trace=False, seconds=1.5, seed=tiny.SEED):
    return harness.run_cell(root, cell, seed, seconds, trace, torch.device("cpu"), 0.0)


def test_serve_cell_runs_and_is_correct(root):
    r, res = run(root, tiny.CHAT)
    assert res["correct"] is True
    assert {"decode_tokens_per_s", "itl_p95_ms", "ttft_p90_ms", "setup_s"} <= set(res["metrics"])
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == {"max_gap", "short_requests"}
    assert len(r.sample) == 6
    # the longest request finished in the window is in the sample
    done = [q for q in r.requests if r.in_window(q.done)]
    assert max(len(q.spec.prompt) + len(q.obj.tokens) for q in done) == \
        len(r.sample[0].spec.prompt) + len(r.sample[0].obj.tokens)
    json.dumps(res)


def test_serve_cell_traced(root):
    r, res = run(root, tiny.CHAT, trace=True)
    assert res["correct"] is True
    assert {"prefill_ms_p50", "step_ms_p50", "idle_share.decode", "mfu.decode",
            "idle_share.prefill", "mfu.prefill"} <= set(res["metrics"])
    # no batch_kernel launches on the CPU: its roofline has nothing to read
    assert "b5_roofline" not in res["metrics"]
    assert res["device"]["busy_s"] > 0 and res["device"]["window_s"] > 0
    assert len(res["breakdown"]["device_ops"]) <= 10
    assert len(res["breakdown"]["idle_gaps"]) <= 10


def test_ppl_cell_runs_and_is_correct(root):
    r, res = run(root, tiny.PPL)
    assert res["correct"] is True
    assert {"ppl_tokens_per_s", "setup_s"} <= set(res["metrics"])
    assert set(res["checks"]) == {"nll_rms", "tok_nll_rms", "mean_gap", "short_batches"}
    assert len(r.sample) == 2
    # the second scoring of the sample repeats the window's forward
    assert r.details["rerun_gap"] < 1e-4
    assert r.details["tokens"] == 2 * 2 * 127


def test_ppl_cell_traced(root):
    _, res = run(root, tiny.PPL, trace=True)
    assert res["correct"] is True
    assert {"idle_share.ppl", "mfu.ppl"} <= set(res["metrics"])


def test_same_seed_same_served_tokens(root):
    a, _ = run(root, tiny.CHAT, seconds=0.5)
    b, _ = run(root, tiny.CHAT, seconds=0.5)
    ta = {tuple(q.spec.prompt): q.obj.tokens for q in a.requests if q.done > 0}
    tb = {tuple(q.spec.prompt): q.obj.tokens for q in b.requests if q.done > 0}
    common = set(ta) & set(tb)
    assert common and all(ta[k] == tb[k] for k in common)


# --- the timed path broken underneath: every fault must read as not correct


def _break_scatter(monkeypatch):
    """A step that returns its state unchanged: no K/V row reaches the pool."""
    from mi_optimize_tpu_torch.serving import megadecode

    monkeypatch.setattr(megadecode, "_scatter_rows_paged", lambda pool, *a, **k: pool)


def _break_half_batch(monkeypatch):
    """Half of each launch's rows left out: they take the other half's logits."""
    from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher

    orig = PagedMegaBatcher._launch

    def launch(self, tokens, table, positions):
        lg = orig(self, tokens, table, positions).clone()
        h = lg.shape[0] // 2
        lg[h:2 * h] = lg[:h]
        return lg

    monkeypatch.setattr(PagedMegaBatcher, "_launch", launch)


def _break_token(monkeypatch):
    """A token altered where it is produced: in each launch one row's best
    logit moves to the next token id, the row turning from launch to launch."""
    from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher

    orig = PagedMegaBatcher._launch
    n = [0]

    def launch(self, tokens, table, positions):
        lg = orig(self, tokens, table, positions).clone()
        r = n[0] % lg.shape[0]
        n[0] += 1
        t = int(lg[r].argmax())
        lg[r, (t + 1) % lg.shape[1]] = lg[r, t] + 1.0
        return lg

    monkeypatch.setattr(PagedMegaBatcher, "_launch", launch)


@pytest.mark.parametrize("fault", [_break_scatter, _break_half_batch, _break_token])
def test_serve_faults_are_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    _, res = run(root, tiny.CHAT)
    assert res["correct"] is False, res["checks"]


def _break_layers(monkeypatch):
    """A step that returns its state unchanged: every block hands its input on."""
    from mi_optimize_tpu_torch.models import llama

    monkeypatch.setattr(llama, "block_apply", lambda blk, x, *a, **k: (x, None, {}))


def _break_half_tokens(monkeypatch):
    """Half of the batch left out, the mean taken over the rest."""
    from mi_optimize_tpu_torch.models import llama

    orig = llama.causal_lm_loss

    def loss(logits, labels, ignore=-100):
        half = logits.shape[0] // 2
        l, _ = orig(logits[:half], labels[:half], ignore)
        _, c = orig(logits, labels, ignore)
        return l, c

    monkeypatch.setattr(llama, "causal_lm_loss", loss)


def _break_answer(monkeypatch):
    """An answer altered where it is produced: each batch's loss 1% high."""
    from mi_optimize_tpu_torch.eval import ppl

    orig = ppl.batch_loss
    monkeypatch.setattr(ppl, "batch_loss", lambda *a, **k: (orig(*a, **k)[0] * 1.01,
                                                            orig(*a, **k)[1]))


@pytest.mark.parametrize("fault", [_break_layers, _break_half_tokens, _break_answer])
def test_ppl_faults_are_not_correct(root, monkeypatch, fault):
    fault(monkeypatch)
    _, res = run(root, tiny.PPL)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", [tiny.CHAT, tiny.PPL])
def test_control_reads(root, cell):
    """The control (float8 activations: the reference's for serving, the
    program's own fp8 and W4A8 routes for evaluation) runs on a run's sample
    and gives a reading. Whether it separates from the program's readings is a matter
    of the cell's size: test_portbench_card.py holds it at the cells' own."""
    bench = harness.load_json(root, "BENCHMARK.json")
    c, cfg, mix, limits = harness.cell_parts(root, bench, cell)
    driver = harness.load_module(root, f"portbench/drivers/{mix['kind']}.py", "d_" + mix["kind"])
    r = harness.Run(cell=c, cfg=cfg, mix=mix, limits=limits, seed=tiny.SEED, seconds=1.5,
                    trace=False, device=torch.device("cpu"), t_start=0.0)
    driver.drive(r)
    assert r.correct()
    ctl = driver.control(r)
    for c in [ctl] + ([ctl["w4a8"]] if "w4a8" in ctl else []):
        assert set(limits) - {"short_requests", "short_batches"} <= set(c)
        assert all(np.isfinite(v) for v in c.values() if isinstance(v, float))
