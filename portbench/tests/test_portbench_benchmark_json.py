"""BENCHMARK.json keeps to the benchmark's contract, and everything a cell
names is found by name under portbench/."""
import filecmp
import json
import os
import re

import pytest

from portbench import harness
from portbench.tests import tiny

REPO = tiny.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "portbench/run.py"]
    assert bench["paths"] == ["portbench"]
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits in its 43200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_entries(bench):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in bench[group]]
        assert len(names) == len(set(names))
        for e in bench[group]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"])
            for k in ("why", "layer", "source"):
                if k in e and group != "end_to_end" and group != "per_layer":
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert sum(1 for w in bench["workloads"] if w["chips"] == 4) <= max(1, len(bench["workloads"]) // 4)


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for c in cells:
        mine = [m["name"] for m in bench["end_to_end"] if c in m.get("workloads", [c])]
        assert "setup_s" in mine and len(mine) >= 2, c
        layer = [m for m in bench["per_layer"] if c in m["workloads"]]
        assert layer, c
        for m in layer:
            assert m["moves"] in mine, (c, m["name"])


def test_layers_named_alike(bench):
    """A layer's name is one short line, and the names of the layers that
    carry a roofline or a share of the peak are written alike everywhere."""
    for m in bench["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"] and "\t" not in m["layer"]
        assert m["layer"] == m["layer"].strip() and "  " not in m["layer"]
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    by_name = {}
    for m in bench["per_layer"]:
        by_name.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_name.values()), by_name


def test_everything_is_found_by_name(bench):
    pb = os.path.join(REPO, "portbench")
    for c in bench["configs"]:
        assert c["file"].startswith("portbench/") and os.path.exists(os.path.join(REPO, c["file"]))
        with open(os.path.join(REPO, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        for k in c["reduced"]:
            assert not re.search(r"(_dim|_rank|size|heads|experts_per_tok)$", k)
    for w in bench["workloads"]:
        with open(os.path.join(pb, "traffic", f"{w['traffic']}.json")) as f:
            kind = json.load(f)["kind"]
        assert os.path.exists(os.path.join(pb, "drivers", f"{kind}.py"))
        assert os.path.exists(os.path.join(pb, "limits", f"{w['name']}.json"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(REPO, harness.metric_file(REPO, m["name"]))), m["name"]


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of the benchmark gains a configuration, two mixes and their
    cells (tests/tiny.py); every file the copy shares with the benchmark is
    unchanged. test_portbench_drivers.py runs those cells."""
    root = tiny.make_root(tmp_path)
    ours = os.path.join(REPO, "portbench")
    for d, _, files in os.walk(os.path.join(root, "portbench")):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), os.path.join(root, "portbench"))
            mine = os.path.join(ours, rel)
            if os.path.exists(mine):
                assert filecmp.cmp(mine, os.path.join(d, f), shallow=False), rel
            else:
                assert rel in ("configs/tiny.json", "traffic/tinychat.json",
                               "traffic/tinyppl.json", "limits/tiny.chat.json",
                               "limits/tiny.ppl.json"), rel
