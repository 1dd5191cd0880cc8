"""The port's beam search (serving/beam.py) against the JAX package's, on
the reference beam test's model (the aligned small Llama, 2 layers, seed
22, int4, fused for serving, f32) with the plain versions of the batched
kernel's paged mode (b) on the CPU.

- The reference test's case (a 150-token prompt: one full shared page and a
  mid-page tail; W=3, 7 new tokens) against JAX's beam_search in interpret
  mode: the same hypotheses, scores within rtol 1e-4 (the two packages'
  logits differ in their last bits).
- eos absorption (the greedy third token as eos) against the dense-cache
  reference on mode (a) (chip_smoke.dense_beam, the port's copy of the JAX
  test's _dense_beam): the same hypotheses, scores within rtol 1e-5; with
  W=1 the greedy hypothesis finishes at the eos and the beam goes on.
- W=1 equals PagedMegaBatcher's greedy tokens with one slot.
- The device top-k orders equal values by the lower id, also at the k-th
  place (lax.top_k's choice); a model the
  batched kernel cannot serve, or a page size that does not divide
  max_len, raises ValueError.
"""
import numpy as np
import pytest
import torch

from chip_smoke import dense_beam
from mi_optimize_tpu.serving.beam import beam_search as jax_beam_search
from mi_optimize_tpu_torch.serving import beam
from mi_optimize_tpu_torch.serving.beam import beam_search
from mi_optimize_tpu_torch.serving.paged import PagedMegaBatcher
from tests.test_torch_convert import port_model
from tests.test_torch_model_fused import fused_pair, jax_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread a test process (the suite's workers share the
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jf, _, pf, _ = fused_pair(jax_model(seed=22))
    return jf, pf


def _same(got, ref, rtol=1e-5):
    assert len(got) == len(ref)
    for (gt, gs), (rt, rs) in zip(got, ref):
        assert gt == rt, (gt, rt)
        np.testing.assert_allclose(gs, rs, rtol=rtol)


def test_beam_matches_jax(pair):
    jf, pf = pair
    prompt = np.random.default_rng(47).integers(0, 128, (150,))
    ref = jax_beam_search(jf, prompt, beam_width=3, max_new_tokens=7, max_len=256)
    got = beam_search(pf, prompt, beam_width=3, max_new_tokens=7, max_len=256)
    # the two packages' logits differ in their last bits (the dequant dots
    # sum in other orders; test_torch_paged holds them within 2e-4 of
    # max|ref|) and a score sums 7 of their log-probs: 1e-4 relative
    _same(got, ref, rtol=1e-4)
    assert len(got) == 3 and all(len(t) == 7 for t, _ in got)


def test_beam_with_eos_absorption(pair):
    _, pf = pair
    prompt = np.random.default_rng(53).integers(0, 128, (40,))
    probe = beam_search(pf, prompt, beam_width=1, max_new_tokens=4, max_len=256)
    eos = probe[0][0][2]
    ref = dense_beam(pf, prompt, 3, 6, eos=eos)
    got = beam_search(pf, prompt, beam_width=3, max_new_tokens=6, eos_token_id=eos, max_len=256)
    _same(got, ref)
    # the greedy beam finishes a hypothesis at its eos and goes on without it
    one = beam_search(pf, prompt, beam_width=1, max_new_tokens=6, eos_token_id=eos, max_len=256,
                      n_best=3)
    assert probe[0][0][:3] in [t for t, _ in one] and len(one) == 2


def test_beam_width1_equals_greedy(pair):
    _, pf = pair
    prompt = np.random.default_rng(59).integers(0, 128, (60,))
    ref = list(PagedMegaBatcher(pf, n_slots=1, max_len=256, page_size=128, n_pages=4)
               .run_all([prompt], max_new_tokens=6).values())[0]
    got = beam_search(pf, prompt, beam_width=1, max_new_tokens=6, max_len=256)
    assert got[0][0] == ref


@pytest.mark.parametrize("case", ["bf16", "f32_integers", "signed_zeros"])
def test_topk_order_is_lax_top_k(case):
    """paged._topk (a stable sort of order-preserving int32 keys) gives
    lax.top_k's values and ids, ties at the k-th place and signed zeros
    included."""
    import jax
    import jax.numpy as jnp

    from mi_optimize_tpu_torch.serving.paged import _topk

    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((8, 4000)) * 4, dtype=torch.bfloat16)
    if case == "f32_integers":
        x = torch.tensor(rng.integers(-4, 4, (8, 4000)), dtype=torch.float32)
    elif case == "signed_zeros":
        x = torch.tensor(rng.integers(-1, 1, (8, 4000)), dtype=torch.float32)
        x[:, ::3] = -0.0
    for k in (1, 8, 256, 3999):
        v, i = _topk(x, k)
        rv, ri = jax.lax.top_k(jnp.asarray(x.to(torch.float32).numpy()), k)
        np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
        np.testing.assert_array_equal(v.numpy(), np.asarray(rv))


def test_topk_ties_and_refusals(pair):
    _, pf = pair
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0, 2.0], [5.0, 1.0, 1.0, 1.0, 0.0]])
    packed = beam._topk_logprobs(logits, 3)
    np.testing.assert_array_equal(packed[1].view(np.int32), [[1, 2, 4], [0, 1, 2]])
    lse = torch.logsumexp(logits, -1, keepdim=True)
    np.testing.assert_allclose(packed[0], (torch.sort(logits, -1, descending=True).values[:, :3]
                                           - lse).numpy(), rtol=1e-6)
    unfused = port_model(jax_model(seed=22))
    with pytest.raises(ValueError, match="megakernel contract"):
        beam_search(unfused, np.arange(10), beam_width=2, max_new_tokens=2, max_len=256)
    with pytest.raises(ValueError, match="page size"):
        beam_search(pf, np.arange(10), beam_width=2, max_new_tokens=2, max_len=256, page_size=96)
