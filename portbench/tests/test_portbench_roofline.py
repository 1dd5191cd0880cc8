"""The yardstick against hand counts, for both configurations."""
import json
import os

import pytest

from portbench import roofline

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GB = 1e9


def shapes(name):
    with open(os.path.join(HERE, "configs", f"{name}.json")) as f:
        return roofline.Shapes(json.load(f))


MISTRAL = "mistral-7b-v0.3-int4g128"
BAICHUAN = "baichuan2-7b-int4g128"


def test_weight_bytes_by_hand():
    s = shapes(MISTRAL)
    # a layer: q 4096x4096, k, v 4096x1024, o 4096x4096, gate, up 4096x14336,
    # down 14336x4096 = 218,103,808 parameters, half a byte each plus an f32
    # scale per 128
    assert s.layer_params() == 218_103_808
    per = 218_103_808 / 2 + 218_103_808 / 128 * 4 + 2 * 4096 * 2
    assert s.decoder_weight_bytes() == pytest.approx(32 * per)
    assert s.lm_head_bytes() == pytest.approx(32768 * 4096 / 2 + 32768 * 32 * 4 + 4096 * 2)
    b = shapes(BAICHUAN)
    assert b.layer_params() == 4 * 4096 * 4096 + 3 * 4096 * 11008
    assert b.lm_head_bytes() == pytest.approx(125696 * 4096 * (0.5 + 4 / 128) + 8192)


def test_mistral_step_at_eight_rows_near_300():
    s = shapes(MISTRAL)
    pos = [296, 298, 300, 300, 301, 302, 303, 304]
    c = roofline.decode_step_cost(pos, s)
    # weights 3.71 GB + lm_head 0.07 GB + K/V of ~2400 live rows, 32 layers,
    # 8 heads of (128 codes + 4 scale bytes), K and V: 0.16 GB
    kv = sum(p + 1 for p in pos) * 32 * 2 * 8 * (128 + 4)
    assert kv / GB == pytest.approx(0.163, abs=0.002)
    assert c.bytes / GB == pytest.approx(3.94, abs=0.02)
    assert c.seconds() == pytest.approx(c.bytes / roofline.PEAK_HBM_BYTES)
    # the kernel's own launch: the same without the lm_head
    k = roofline.batch_kernel_cost(pos, s)
    assert (c.bytes - k.bytes) == pytest.approx(s.lm_head_bytes() + 8 * 32768 * 2)


def test_baichuan_kv_is_four_times_mistrals():
    m, b = shapes(MISTRAL), shapes(BAICHUAN)
    assert b.kv_row_bytes() == 4 * m.kv_row_bytes()


def test_prefill_and_gemms_by_hand():
    s = shapes(MISTRAL)
    n = 1536
    g = roofline.prefill_gemms(n, s)
    assert len(g) == 4 * 32
    flops = sum(c.flops for c in g)
    assert flops == pytest.approx(2 * n * 32 * s.layer_params())
    p = roofline.prefill_cost(n, s)
    attn = 32 * 4 * 32 * 128 * n * (n + 1) / 2
    assert p.flops == pytest.approx(flops + attn + 2 * 4096 * 32768)
    # long prompts are bound by the tensor cores, not by HBM
    assert p.flops / roofline.PEAK_BF16_FLOPS > p.bytes / roofline.PEAK_HBM_BYTES
    # a 64-row product reads more than it computes at these peaks
    small = roofline.linear_cost(64, 4096, 4096, s)
    assert small.bytes / roofline.PEAK_HBM_BYTES > small.flops / roofline.PEAK_BF16_FLOPS


def test_ppl_batch_by_hand():
    s = shapes(BAICHUAN)
    c = roofline.ppl_batch_cost(1, 2048, s)
    # about 31 TFLOP a 2048-token batch: 2 x 2048 x (6.5e9 + 0.51e9) + attention
    assert c.flops / 1e12 == pytest.approx(2 * 2048 * (32 * s.layer_params() + 4096 * 125696) / 1e12
                                           + 32 * 4 * 4096 * 2048 * 2049 / 2 / 1e12)
    assert 28 < c.flops / 1e12 < 32
    g = roofline.ppl_gemms(1, 2048, s)
    assert len(g) == 5 * 32 + 1
    assert sum(x.flops for x in g) == pytest.approx(2 * 2048 * (32 * s.layer_params()
                                                                + 4096 * 125696))
