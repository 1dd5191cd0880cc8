"""Tokenizer adapters.

A copy of mi_optimize_tpu/datasets/tokenizer.py. The loaders take any HF-style
tokenizer (a callable returning input_ids); `ByteTokenizer` is the
deterministic byte-level fallback for machines with no tokenizer files, so
the calibration and evaluation pipelines run end to end offline (its
perplexities are comparable only among themselves).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class ByteTokenizer:
    """UTF-8 byte-level tokenizer: vocab = 256 bytes + BOS/EOS/PAD."""

    def __init__(self):
        self.bos_token_id = 256
        self.eos_token_id = 257
        self.pad_token_id = 258
        self.vocab_size = 259

    def encode(self, text: str, add_bos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.bos_token_id] + ids) if add_bos else ids

    def decode(self, ids) -> str:
        return bytes(i for i in np.asarray(ids).reshape(-1).tolist() if i < 256).decode(
            "utf-8", errors="replace"
        )

    def __call__(self, text: str, **kw):
        ids = np.asarray(self.encode(text), dtype=np.int64)[None, :]
        return {"input_ids": ids}


def encode_ids(tokenizer, text: str) -> np.ndarray:
    """Normalize HF-style / ByteTokenizer call results to np.int64 [1, T]."""
    out = tokenizer(text)
    ids = out["input_ids"] if isinstance(out, dict) else out.input_ids
    ids = np.asarray(ids)
    if ids.ndim == 1:
        ids = ids[None, :]
    return ids.astype(np.int64)
