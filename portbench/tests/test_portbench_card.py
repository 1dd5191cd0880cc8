"""On the card: each cell's control comes out as not correct at the cell's own
size, where the program's own run is correct. Skips without a CUDA card.

    python -m pytest -m cuda portbench/tests/test_portbench_card.py
"""
import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CELLS = {"mistral-7b.chat32": 20.0, "baichuan2-7b.ppl2048": 8.0, "mistral-7b.rag16": 20.0,
         "baichuan2-7b.chat32": 20.0}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run only on the chip")
    from mi_optimize_tpu_torch.ops import _build

    _build.build_all()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_where_the_program_passes(card, cell):
    root = tiny.REPO
    bench = harness.load_json(root, "BENCHMARK.json")
    if cell not in {w["name"] for w in bench["workloads"]}:
        pytest.skip(f"{cell} is not a cell of BENCHMARK.json")
    c, cfg, mix, limits = harness.cell_parts(root, bench, cell)
    driver = harness.load_module(root, f"portbench/drivers/{mix['kind']}.py",
                                 "card_" + mix["kind"])
    r = harness.Run(cell=c, cfg=cfg, mix=mix, limits=limits, seed=7,
                    seconds=CELLS[cell], trace=False, device=card, t_start=0.0)
    driver.drive(r)
    assert r.correct(), r.checks
    ctl = driver.control(r)
    # every control route of the cell comes out as not correct
    for c in [ctl] + ([ctl["w4a8"]] if "w4a8" in ctl else []):
        assert any(c[k] > lim for k, lim in limits.items() if k in c), (c, limits)
