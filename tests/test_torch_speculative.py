"""The port's speculative decoding (serving/speculative.py) against the JAX
package, token for token and stat for stat, mirroring tests/test_planted.py
(:68-155) and tests/test_serving.py::test_speculative_decoding_exact_and_saves_calls.

Planted pairs (utils/planted.py) built by JAX in float32 and carried over
with convert.from_jax_params: a 2-layer target and a 1-layer draft whose
greedy chains follow the planted maps. Every route emits the target's chain
exactly; the stats (target and draft calls, accept rate, the adaptive k
history and q_hat) equal JAX's on the same inputs. The scan-flat route runs
the kernels' plain versions on the CPU: the flat draft, the chunk verify
with the fused lm rows (mode d) at C <= 6, and at k = 8 the split C = 9
verify (a sub-chunk of 8 rows, then one). Each JAX reference is computed
once per module."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mi_optimize_tpu.models.llama import LlamaConfig as JLlamaConfig
from mi_optimize_tpu.models.model import Model as JModel
from mi_optimize_tpu.serving import fuse_for_serving as jax_fuse_for_serving
from mi_optimize_tpu.serving import generate as jax_generate
from mi_optimize_tpu.serving.speculative import speculative_generate as jax_spec
from mi_optimize_tpu.utils.planted import planted_pair as jax_planted_pair
from mi_optimize_tpu_torch.ops import model_fused
from mi_optimize_tpu_torch.serving import engine
from mi_optimize_tpu_torch.serving.optimize import fuse_for_serving
from mi_optimize_tpu_torch.serving.speculative import ADAPT_COST, _best_k, speculative_generate
from tests.test_torch_convert import port_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return JLlamaConfig(vocab_size=128, hidden_size=512, intermediate_size=1024, num_layers=2,
                        num_heads=4, num_kv_heads=2, head_dim=128, max_seq_len=512)


def _chain(m, t, n):
    out = []
    for _ in range(n):
        t = int(m[t])
        out.append(t)
    return out


# name: (disagree_frac, prompt, max_new_tokens, keyword arguments)
RUNS = {
    "scan-flat": (0.0, [9, 77], 11, dict(k=3, draft_megakernel=True)),
    "adaptive": (0.0, [9, 77], 60, dict(k="auto", draft_megakernel=True)),
    "host-0.0": (0.0, [11, 23], 12, dict(k=3, draft_megakernel=False, on_device=False)),
    "host-0.5": (0.5, [11, 23], 12, dict(k=3, draft_megakernel=False, on_device=False)),
}


@functools.lru_cache(maxsize=None)
def jax_planted(frac):
    """JAX's planted pair at this disagreement fraction (a 2-layer f32 target,
    a 1-layer draft), fused, the port's fused copies and the target's map:
    (jt, jd, pt, pd, m_t). Built once a process (JAX compiles the packing of
    every planted linear anew); callers must not mutate the models."""
    jt, jd, m_t, _ = jax_planted_pair(_cfg(), draft_layers=1, disagree_frac=frac,
                                      dtype=jnp.float32)
    return (jax_fuse_for_serving(jt), jax_fuse_for_serving(jd),
            fuse_for_serving(port_model(jt)), fuse_for_serving(port_model(jd)), m_t)


@pytest.fixture(scope="module")
def planted():
    """For each disagreement fraction: jax_planted's five."""
    return {frac: jax_planted(frac) for frac in (0.0, 0.5)}


@pytest.fixture(scope="module")
def jax_runs(planted):
    out = {}
    for name, (frac, prompt, n, kw) in RUNS.items():
        jt, jd = planted[frac][:2]
        out[name] = jax_spec(jt, jd, np.array([prompt]), max_new_tokens=n, fused=False,
                             cache_dtype=jnp.int8, **kw)
    return out


def _lm_calls(monkeypatch):
    """Record (rows, chunk, fused lm rows given) of every batched-kernel call."""
    calls = []
    ref = model_fused.model_decode_mega_batch_ref

    def spy(stack, x, cos, sin, cache, positions, cfg, meta, table=None, chunk=1, lm=None,
            lm_meta=None):
        calls.append((x.shape[0], chunk, lm is not None))
        return ref(stack, x, cos, sin, cache, positions, cfg, meta, table, chunk, lm, lm_meta)

    monkeypatch.setattr(model_fused, "model_decode_mega_batch_ref", spy)
    return calls


@pytest.mark.parametrize("name", list(RUNS))
def test_spec_routes_match_jax(planted, jax_runs, name, monkeypatch):
    frac, prompt, n, kw = RUNS[name]
    _, _, pt, pd, m_t = planted[frac]
    calls = _lm_calls(monkeypatch)
    toks, stats = speculative_generate(pt, pd, np.array([prompt]), max_new_tokens=n, fused=False,
                                       cache_dtype=torch.int8, **kw)
    jtoks, jstats = jax_runs[name]
    assert toks.reshape(-1)[2:].tolist() == _chain(m_t, prompt[-1], n)
    np.testing.assert_array_equal(toks, np.asarray(jtoks))
    assert stats == jstats
    if name == "scan-flat":
        # C = 4 verify chunks, all through the fused lm rows
        assert stats["scan_segments"] and calls and all(c == (4, 4, True) for c in calls)
    if name == "adaptive":
        assert stats["adaptive_k"][-1] == 8 and len(stats["adaptive_k"]) >= 2
        # k = 8: the C = 9 verify as a sub-chunk of 8 rows then one row,
        # with the lm_head after the kernel (C > 6)
        assert (8, 8, False) in calls and (1, 1, False) in calls
        assert (5, 5, True) in calls
    if name == "host-0.5":
        assert 0.03 <= stats["accept_rate"] <= 0.8


def test_speculative_decoding_exact_and_saves_calls():
    """The port of tests/test_serving.py's test: with the target as its own
    draft every proposal is accepted; with an int8 RTN draft the output is
    still the target's greedy decode; the while-loop route (`_spec_loop`,
    the default on the CPU) and the host loop give JAX's tokens and stats."""
    import mi_optimize_tpu as mt
    from mi_optimize_tpu.quant.config import QuantConfig

    jm = JModel.tiny_llama()
    rng = np.random.default_rng(12)
    prompt = rng.integers(0, 256, (1, 8))
    jdraft = mt.quantize(jm, QuantConfig(algo="rtn", wbit="int8", w_qtype="per_channel",
                                         pack=False), calib_data=[prompt])
    pm, pdraft = port_model(jm), port_model(jdraft)
    ref = engine.generate(pm, prompt, max_new_tokens=12, fused=False)
    np.testing.assert_array_equal(ref, jax_generate(jm, prompt, max_new_tokens=12, fused=False))

    out, stats = speculative_generate(pm, pm, prompt, max_new_tokens=12, k=4, fused=False)
    np.testing.assert_array_equal(out, ref)
    assert stats["accept_rate"] == 1.0 and stats["target_calls"] <= 12 // 4 + 1
    for on_device in (True, False):
        out2, st2 = speculative_generate(pm, pdraft, prompt, max_new_tokens=12, k=4, fused=False,
                                         on_device=on_device)
        _, jst2 = jax_spec(jm, jdraft, prompt, max_new_tokens=12, k=4, fused=False,
                           on_device=on_device)
        np.testing.assert_array_equal(out2, ref)
        assert st2 == jst2


def test_cost_model_and_fused_lm_gate(planted, monkeypatch):
    """The reference's tuned constants are parameters: `cost_model` replaces
    the k-selection table (a table that makes k = 2 cheapest settles there),
    and `fused_lm_max_chunk` gates the fused lm rows (0: the lm_head after
    the kernel for every verify chunk). Tokens stay the target's chain."""
    _, _, pt, pd, m_t = planted[0.0]
    assert _best_k(1.0) == 8 and _best_k(1.0, cost=ADAPT_COST) == 8
    cheap2 = dict(ADAPT_COST, round_ms={2: 1.0, 4: 50.0, 8: 90.0})
    assert _best_k(1.0, cost=cheap2) == 2
    calls = _lm_calls(monkeypatch)
    toks, stats = speculative_generate(pt, pd, np.array([[9, 77]]), max_new_tokens=44, k="auto",
                                       fused=False, cache_dtype=torch.int8, draft_megakernel=True,
                                       cost_model=cheap2, fused_lm_max_chunk=0)
    assert toks.reshape(-1)[2:].tolist() == _chain(m_t, 77, 44)
    assert stats["adaptive_k"][0] == 4 and stats["adaptive_k"][-1] == 2
    assert calls and not any(lm for _, _, lm in calls)
