"""Speculative decoding over the page pool: the port's PagedSpeculativeBatcher
(serving/paged.py) on the batched kernel's plain versions, float32, the port
of tests/test_paged_spec.py. The reference's own tests of this batcher run
its kernels in interpret mode and are marked slow; here the greedy tokens
are held to the port's PagedMegaBatcher (itself held to JAX's batchers in
tests/test_torch_paged.py) and, on planted models, to the planted chain.

- draft == target (a random 2-layer model): every proposal accepted, tokens
  equal to the plain paged batcher's, pages recycled through a 5-page pool;
- a planted draft that disagrees on half its map: the target's chain, fewer
  acceptances than proposals;
- the verify waves: 4 slots, k=3 (waves of 2 slots x 4 rows) and 3-slot
  waves (a short wave padded with its last slot; 12 rows a wave, launched
  as 2 slots, then 1): the same tokens."""
import numpy as np
import pytest
import torch

from mi_optimize_tpu_torch.models.llama import LlamaConfig
from mi_optimize_tpu_torch.models.model import Model
from mi_optimize_tpu_torch.models.synthetic import build_quantized_llama
from mi_optimize_tpu_torch.ops import model_fused
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher, PagedSpeculativeBatcher
from mi_optimize_tpu_torch.utils.planted import planted_pair


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = LlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=1024, num_layers=2,
                  num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)


def _chain(m, t, n):
    out = []
    for _ in range(n):
        t = int(m[t])
        out.append(t)
    return out


def test_paged_speculative_batcher_exact_and_recycles():
    model = fuse_for_serving(Model(config=CFG, params=build_quantized_llama(
        CFG, dtype=torch.float32, seed=22, device="cpu")))
    rng = np.random.default_rng(29)
    prompts = [rng.integers(0, 128, (100 + 7 * i,)) for i in range(4)]
    ref = PagedMegaBatcher(model, n_slots=2, max_len=256, n_pages=6).run_all(
        list(prompts), max_new_tokens=10)
    sb = PagedSpeculativeBatcher(model, model, k=3, n_slots=2, max_len=256, n_pages=6)
    got = sb.run_all(list(prompts), max_new_tokens=10)
    assert got == ref
    assert sb.accepted == sb.proposed and sb.rounds > 0
    assert sorted(sb.free_pages) == list(range(1, 6))
    assert (sb.table == 0).all()


@pytest.fixture(scope="module")
def planted():
    t, d, m_t, _ = planted_pair(CFG, draft_layers=1, disagree_frac=0.5, dtype=torch.float32,
                                device="cpu")
    return fuse_for_serving(t), fuse_for_serving(d), m_t


@pytest.mark.parametrize("n_slots,wave", [(2, None), (4, None), (3, 3)])
def test_paged_speculative_batcher_degraded_draft_and_waves(planted, n_slots, wave,
                                                            monkeypatch):
    target, draft, m_t = planted
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 128, (int(n),)) for n in rng.integers(20, 140, 5)]
    rows = []
    launch = model_fused.model_decode_mega_batch

    def spy(*a, **k):
        rows.append((a[1].shape[0], k.get("chunk")))
        return launch(*a, **k)

    monkeypatch.setattr(model_fused, "model_decode_mega_batch", spy)
    sb = PagedSpeculativeBatcher(target, draft, k=3, n_slots=n_slots, max_len=256,
                                 verify_wave_slots=wave)
    got = sb.run_all(list(prompts), max_new_tokens=8)
    assert [got[i] for i in range(5)] == [_chain(m_t, int(p[-1]), 8) for p in prompts]
    assert 0 < sb.accepted < sb.proposed
    verify = {r for r, c in rows if c == 4}
    assert verify == ({8, 4} if wave else {8})
