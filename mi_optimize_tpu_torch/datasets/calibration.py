"""Calibration and test data loaders (wikitext2 / PTB / C4).

Port of mi_optimize_tpu/datasets/calibration.py, with the same protocol:
  * train split -> `nsamples` random seqlen crops of the tokenized join
    (wikitext joined with "\\n\\n", PTB sentences with " "), seeded RNG;
  * test split  -> contiguous seqlen chunks;
  * get_calibrate_loader dispatches on calibrate_config.name.

Corpora resolve from MI_TPU_DATA_DIR, then the repository's data/. The
bundled wikitext and PTB splits are HF builder-cache `.arrow` files, each an
Arrow IPC stream; `read_arrow_stream` reads their string columns with numpy
and the standard library (no `datasets` or `pyarrow` package). C4 reads
allenai-layout json.gz shards from MI_TPU_DATA_DIR/c4. The C-Eval, CMMLU and
BOSS calibration sets come from datasets.ceval / cmmlu / boss: one
[1, L <= seqlen] array per question or example, of varying L.
"""
from __future__ import annotations

import glob
import logging
import os
import random
import struct
from typing import Dict, List, Optional

import numpy as np

from ..quant.config import CalibrationConfig
from .tokenizer import encode_ids

log = logging.getLogger(__name__)

_DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "data")


def _search_dirs():
    # MI_TPU_DATA_DIR read per call (not at import) so tests/launchers can set it
    return (os.environ.get("MI_TPU_DATA_DIR", ""), _DATA)


def find_data_path(name: str) -> Optional[str]:
    for d in _search_dirs():
        if not d:
            continue
        p = os.path.join(d, name)
        if os.path.exists(p):
            return p
    return None


def _crops(token_ids: np.ndarray, nsamples, seqlen: int, seed: int, split: str):
    """Random train crops / contiguous test chunks of a [1, T] id array."""
    T = token_ids.shape[1]
    if split == "train":
        rng = random.Random(seed)
        out = []
        for _ in range(nsamples):
            i = rng.randint(0, T - seqlen - 1)
            out.append(token_ids[:, i : i + seqlen])
        return out
    n = (T // seqlen) if nsamples == "all" else int(nsamples)
    return [token_ids[:, i * seqlen : (i + 1) * seqlen] for i in range(n)
            if (i + 1) * seqlen <= T or split != "test"]


# ---------------------------------------------------------------------------
# Arrow IPC stream reader (string columns)
# ---------------------------------------------------------------------------

_SCHEMA, _RECORD_BATCH = 1, 3   # MessageHeader union tags
_UTF8, _LARGE_UTF8 = 5, 20       # Type union tags


class _Table:
    """A flatbuffer table at `pos` of `buf`."""

    def __init__(self, buf, pos):
        self.buf, self.pos = buf, pos
        self.vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt_len = struct.unpack_from("<H", buf, self.vt)[0]

    def _off(self, field):
        o = 4 + 2 * field
        return struct.unpack_from("<H", self.buf, self.vt + o)[0] if o < self.vt_len else 0

    def scalar(self, field, fmt):
        o = self._off(field)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + o)[0] if o else 0

    def _target(self, field):
        o = self._off(field)
        if not o:
            return None
        p = self.pos + o
        return p + struct.unpack_from("<I", self.buf, p)[0]

    def table(self, field):
        p = self._target(field)
        return None if p is None else _Table(self.buf, p)

    def vector(self, field):
        """(element count, position of element 0), or (0, None)."""
        p = self._target(field)
        if p is None:
            return 0, None
        return struct.unpack_from("<I", self.buf, p)[0], p + 4

    def tables(self, field):
        n, p = self.vector(field)
        return [_Table(self.buf, p + 4 * i + struct.unpack_from("<I", self.buf, p + 4 * i)[0])
                for i in range(n)]

    def string(self, field):
        p = self._target(field)
        if p is None:
            return None
        n = struct.unpack_from("<I", self.buf, p)[0]
        return bytes(self.buf[p + 4:p + 4 + n]).decode("utf-8")


def _messages(data: bytes):
    """(Message table, body bytes) of each encapsulated message of a stream."""
    pos = 0
    while pos + 4 <= len(data):
        size = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        if size == -1:  # continuation marker, then the metadata size
            size = struct.unpack_from("<i", data, pos)[0]
            pos += 4
        if size == 0:  # end of stream
            return
        meta = memoryview(data)[pos:pos + size]
        pos += size
        msg = _Table(meta, struct.unpack_from("<I", meta, 0)[0])
        body_len = msg.scalar(3, "q")
        yield msg, memoryview(data)[pos:pos + body_len]
        pos += body_len


def _strings(body, node, bufs, large):
    """The values of one utf8 column (None where null) from its field node
    and its validity, offsets and data buffers."""
    n, nulls = node
    (vo, vl), (oo, _), (do, dl) = bufs
    offsets = np.frombuffer(body, np.int64 if large else np.int32, n + 1, oo)
    data = bytes(body[do:do + dl])
    valid = (np.unpackbits(np.frombuffer(body, np.uint8, (n + 7) // 8, vo), bitorder="little")
             if nulls and vl else np.ones(n, np.uint8))
    return [data[offsets[i]:offsets[i + 1]].decode("utf-8") if valid[i] else None
            for i in range(n)]


def read_arrow_stream(path: str) -> Dict[str, list]:
    """The string columns of an Arrow IPC stream file, {name: values}, record
    batches concatenated. Any other column type, dictionary encoding or
    compression raises."""
    with open(path, "rb") as f:
        data = f.read()
    fields, cols = None, None
    for msg, body in _messages(data):
        kind = msg.scalar(1, "B")
        header = msg.table(2)
        if kind == _SCHEMA:
            fields = []
            for fld in header.tables(1):
                ttype = fld.scalar(2, "B")
                if ttype not in (_UTF8, _LARGE_UTF8) or fld.table(4) is not None:
                    raise ValueError(f"{path}: column {fld.string(0)!r} is not a plain string "
                                     f"column (Arrow type {ttype})")
                fields.append((fld.string(0), ttype))
            cols = {name: [] for name, _ in fields}
        elif kind == _RECORD_BATCH:
            if fields is None:
                raise ValueError(f"{path}: record batch before the schema")
            if header.table(3) is not None:
                raise ValueError(f"{path}: compressed record batches are not supported")
            nn, np_ = header.vector(1)
            nodes = [struct.unpack_from("<qq", header.buf, np_ + 16 * i) for i in range(nn)]
            nb, bp = header.vector(2)
            bufs = [struct.unpack_from("<qq", header.buf, bp + 16 * i) for i in range(nb)]
            for k, ((name, ttype), node) in enumerate(zip(fields, nodes)):
                cols[name].extend(_strings(body, node, bufs[3 * k:3 * k + 3],
                                           ttype == _LARGE_UTF8))
    if cols is None:
        raise ValueError(f"{path}: no Arrow schema message")
    return cols


def _load_arrow_split(corpus_dir: str, split: str) -> Dict[str, list]:
    """The columns of a split from a bundled HF builder-cache directory
    (.arrow files). Falls back train -> validation when only eval splits are
    bundled (the reference toolbox ships validation/test arrows only) and logs
    the substitution."""
    def find(s):
        hits = glob.glob(os.path.join(corpus_dir, "**", f"*-{s}.arrow"), recursive=True)
        return hits[0] if hits else None

    f = find(split)
    if f is None and split == "train":
        f = find("validation")
        if f is not None:
            log.warning("train split not bundled under %s; using validation for calibration",
                        corpus_dir)
    if f is None:
        raise FileNotFoundError(f"no {split} arrow under {corpus_dir}")
    return read_arrow_stream(f)


def get_wikitext2(tokenizer, split="test", nsamples=128, seqlen=2048, seed=42, **kw):
    path = find_data_path("wikitext")
    if path is None:
        raise FileNotFoundError("wikitext corpus not found; set MI_TPU_DATA_DIR")
    ds = _load_arrow_split(path, split)
    ids = encode_ids(tokenizer, "\n\n".join(ds["text"]))
    return _crops(ids, nsamples, seqlen, seed, split)


def get_ptb(tokenizer, split="test", nsamples=128, seqlen=2048, seed=42, **kw):
    # the bundled PTB is a SYNTHETIC stand-in (scripts/make_data_fixtures.py),
    # so a real corpus under MI_TPU_DATA_DIR comes before it
    dirs = list(_search_dirs())
    local = os.path.abspath(_DATA)
    dirs.sort(key=lambda d: os.path.abspath(d) == local if d else False)
    path = None
    for d in dirs:
        p = os.path.join(d, "ptb_text_only") if d else ""
        if p and os.path.exists(p):
            path = p
            break
    if path is None:
        raise FileNotFoundError("ptb corpus not found; set MI_TPU_DATA_DIR")
    ds = _load_arrow_split(path, split)
    ids = encode_ids(tokenizer, " ".join(ds["sentence"]))
    if split == "test":
        nsamples = ids.shape[1] // seqlen
    return _crops(ids, nsamples, seqlen, seed, split)


def _c4_texts(local: str, split: str) -> List[str]:
    """Texts from local allenai/c4-layout shards (en/c4-<split>-....json.gz or
    a flat dir of .json.gz); shard 0 of the split, as the reference toolbox
    streams it."""
    import gzip
    import json

    # every pattern names the split: a flat dir must NOT serve the same
    # shard to both train (calibration) and validation (evaluation)
    pats = (os.path.join(local, "en", f"c4-{split}*.json.gz"),
            os.path.join(local, f"c4-{split}*.json.gz"),
            os.path.join(local, f"*{split}*.json.gz"))
    for pat in pats:
        files = sorted(glob.glob(pat))
        if files:
            break
    else:
        raise FileNotFoundError(
            f"no {split} .json.gz shards under {local} (allenai layout: "
            f"en/c4-{split}-....json.gz)")
    texts = []
    with gzip.open(files[0], "rt", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if line:
                texts.append(json.loads(line)["text"])
    return texts


def get_c4(tokenizer, split="validation", nsamples=128, seqlen=2048, seed=42, **kw):
    """allenai/c4 semantics:
    train      -> per sample: a random doc with > seqlen tokens, a random crop
    validation -> the first 1100 docs joined, contiguous seqlen chunks
    Resolves offline from MI_TPU_DATA_DIR/c4 (json.gz shards, allenai layout).
    """
    local = find_data_path("c4")
    if local is None:
        raise FileNotFoundError(
            "C4 requires a local copy under MI_TPU_DATA_DIR/c4 "
            "(json.gz shards as in allenai/c4)"
        )
    texts = _c4_texts(local, split)
    if split == "train":
        rng = random.Random(seed)
        encs = {}
        out = []
        for _ in range(int(nsamples)):
            while True:
                i = rng.randint(0, len(texts) - 1)
                if i not in encs:
                    encs[i] = encode_ids(tokenizer, texts[i])
                if encs[i].shape[1] > seqlen:
                    break
            j = rng.randint(0, encs[i].shape[1] - seqlen - 1)
            out.append(encs[i][:, j:j + seqlen])
        return out
    if split == "validation":
        ids = encode_ids(tokenizer, " ".join(texts[:1100]))
        if nsamples == "all":
            nsamples = ids.shape[1] // seqlen + 1
        return [ids[:, i * seqlen:(i + 1) * seqlen] for i in range(int(nsamples))
                if i * seqlen < ids.shape[1]]
    raise ValueError(f"unsupported c4 split {split!r}")


def get_test_loader(dataset_name, tokenizer, seqlen=2048, nsamples=128, seed=42, split="test"):
    if dataset_name == "wikitext2":
        return get_wikitext2(tokenizer, split=split, nsamples=nsamples, seqlen=seqlen, seed=seed)
    if dataset_name == "ptb":
        return get_ptb(tokenizer, split=split, nsamples=nsamples, seqlen=seqlen, seed=seed)
    if dataset_name == "c4":
        return get_c4(tokenizer, nsamples=nsamples, seqlen=seqlen, seed=seed)
    raise ValueError(f"unknown dataset {dataset_name!r}")


def get_calibrate_loader(tokenizer, cfg: CalibrationConfig) -> List[np.ndarray]:
    name = cfg.name
    if name == "wikitext2":
        return get_wikitext2(tokenizer, split=cfg.split, nsamples=cfg.nsamples,
                             seqlen=cfg.seqlen, seed=cfg.seed)
    if name == "ptb":
        return get_ptb(tokenizer, split=cfg.split, nsamples=cfg.nsamples,
                       seqlen=cfg.seqlen, seed=cfg.seed)
    if name == "c4":
        return get_c4(tokenizer, split="train", nsamples=cfg.nsamples,
                      seqlen=cfg.seqlen, seed=cfg.seed)
    if name == "ceval":
        from .ceval import get_calibrate_ceval
        return get_calibrate_ceval(tokenizer, subject=cfg.subject, nsamples=cfg.nsamples,
                                   seqlen=cfg.seqlen)
    if name == "cmmlu":
        from .cmmlu import get_calibrate_cmmlu
        return get_calibrate_cmmlu(tokenizer, subject=cfg.subject, nsamples=cfg.nsamples,
                                   seqlen=cfg.seqlen)
    if name == "boss":
        from .boss import get_calibrate_boss
        return get_calibrate_boss(tokenizer, nsamples=cfg.nsamples, seqlen=cfg.seqlen)
    raise ValueError(f"unsupported calibrate name {name!r}")
