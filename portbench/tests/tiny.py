"""A copy of the benchmark with tiny cells, for CPU runs of its drivers.

`make_root(dir)` copies portbench/ and BENCHMARK.json under `dir` and adds
a tiny configuration (two layers, heads of 128, a 512-row vocabulary), two
tiny mixes (`tinychat`: 10 clients on 10 slots, two waves; `tinyppl`: two
rows of 128 tokens a batch), their cells and limits, and lists the cells in
the metrics of their kind: new files and entries only, as a later change
adds a cell.
"""
import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEED = 2**31 + 12345
CHAT, PPL = "tiny.chat", "tiny.ppl"
LIMITS = {CHAT: {"max_gap": 0.1, "short_requests": 0},
          PPL: {"nll_rms": 0.01, "tok_nll_rms": 0.05, "mean_gap": 0.005, "short_batches": 0}}


def tiny_config() -> dict:
    with open(os.path.join(REPO, "portbench/configs/mistral-7b-v0.3-int4g128.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", hidden_size=512, intermediate_size=1024, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, vocab_size=512,
               max_position_embeddings=4096)
    return cfg


def _dump(obj, path):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def make_root(d) -> str:
    root = str(d)
    shutil.copytree(os.path.join(REPO, "portbench"), os.path.join(root, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    pb = os.path.join(root, "portbench")
    _dump(tiny_config(), os.path.join(pb, "configs/tiny.json"))
    _dump({"kind": "paged_serve", "clients": 10, "slots": 10, "page_size": 128, "max_len": 512,
           "n_pages": 41, "prompt": {"median": 64, "sigma": 0.5, "min": 16, "max": 200},
           "output": {"median": 8, "sigma": 0.5, "min": 2, "max": 24}, "grid": 16,
           "check_requests": 6}, os.path.join(pb, "traffic/tinychat.json"))
    _dump({"kind": "ppl_eval", "seq_len": 128, "batch": 2, "check_batches": 2},
          os.path.join(pb, "traffic/tinyppl.json"))
    for cell, lim in LIMITS.items():
        _dump(lim, os.path.join(pb, f"limits/{cell}.json"))
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "tiny", "source": "a test", "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU runs of the drivers"})
    bench["workloads"] += [
        {"name": CHAT, "config": "tiny", "traffic": "tinychat", "chips": 1, "why": "test"},
        {"name": PPL, "config": "tiny", "traffic": "tinyppl", "chips": 1, "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        ws = m.get("workloads")
        if ws is None:
            continue
        if "mistral-7b.chat32" in ws or "mistral-7b.rag16" in ws:
            ws.append(CHAT)
        if "baichuan2-7b.ppl2048" in ws:
            ws.append(PPL)
    _dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root
