"""Checkpoint: save/load quantized models (packed ints + qparams + manifest).

Port of mi_optimize_tpu/export/checkpoint.py, in its format: one
`arrays.npz` of named arrays and a `manifest.json` (format_version 1) with
the model config and every linear's QuantSpec. A checkpoint that either
package writes loads in the other:

  * packed words are uint32 in the file and the port's int32 bit-view in
    memory (convert.py's rule);
  * numpy has no bfloat16 or float8: the JAX package's ml_dtypes arrays go
    into the npz as 2- and 1-byte void arrays ('<V2', '<V1'), and the port
    writes its bf16 and native fp8 tensors the same way. On load a 2-byte
    void array is bf16 bits, a 1-byte one the fp8 format its linear's spec
    names.

Also the per-block calibration journal (`CalibrationJournal`), which makes a
layer-sequential pass resumable at the last finished block, and
`export_packed`, which turns grid-faithful fake-quant linears into packed
ones.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..memory import BITS
from ..models.llama import LlamaConfig
from ..models.model import Model
from ..models.quant_linear import QuantizedLinear, QuantSpec

_ARRAY_FIELDS = ("weight", "packed", "w_scale", "w_zero", "bias", "smooth_factor",
                 "a_scale", "a_zero", "perm")

_FP8 = {"e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def _to_numpy(t: torch.Tensor, field: Optional[str] = None) -> np.ndarray:
    """The array the npz holds for `t`: packed words as uint32, bf16 and
    fp8 as void arrays of their bits."""
    t = t.detach().cpu()
    if t.dtype in BITS:
        bits = BITS[t.dtype]
        return t.contiguous().view(bits).numpy().view(f"<V{bits.itemsize}")
    a = t.numpy()
    if field == "packed" and a.dtype == np.int32:
        a = a.view(np.uint32)
    return a


def _from_numpy(a: np.ndarray, dev, fp8_format: Optional[str] = None) -> torch.Tensor:
    """Inverse of _to_numpy on `dev` (uint32 words come back as int32). `a`
    is an array np.load just read, so the tensor may share its memory."""
    if a.dtype.kind == "V":
        if a.dtype.itemsize == 2:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        elif a.dtype.itemsize == 1 and fp8_format in _FP8:
            t = torch.from_numpy(a.view(np.uint8)).view(_FP8[fp8_format])
        else:
            raise ValueError(f"cannot read a {a.dtype} array (fp8 format {fp8_format})")
        return t.to(dev)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a).to(dev)


def _lin_manifest(lin: QuantizedLinear) -> Dict[str, Any]:
    return {
        "kind": "quant_linear",
        "spec": dataclasses.asdict(lin.spec),
        "out_features": lin.out_features,
        "in_features": lin.in_features,
        "fields": [f for f in _ARRAY_FIELDS if getattr(lin, f) is not None],
    }


def save_model(model: Model, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    arrays: Dict[str, np.ndarray] = {}
    manifest: Dict[str, Any] = {
        "format_version": 1,
        "family": model.family,
        "config": dataclasses.asdict(model.config),
        "tree": {},
    }

    def put(key: str, node):
        if isinstance(node, QuantizedLinear):
            manifest["tree"][key] = _lin_manifest(node)
            for f in _ARRAY_FIELDS:
                v = getattr(node, f)
                if v is not None:
                    arrays[f"{key}.{f}"] = _to_numpy(v, f)
        else:
            manifest["tree"][key] = {"kind": "array"}
            arrays[key] = _to_numpy(node)

    put("embed", model.params["embed"])
    put("final_norm", model.params["final_norm"])
    if "lm_head" in model.params:
        put("lm_head", model.params["lm_head"])
    manifest["num_layers"] = len(model.params["layers"])
    for i, blk in enumerate(model.params["layers"]):
        for name, node in blk.items():
            put(f"layers.{i}.{name}", node)

    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)


def _load_lin(key: str, meta: Dict, arrays, dev) -> QuantizedLinear:
    spec = QuantSpec(**meta["spec"])
    kw = {}
    for f in _ARRAY_FIELDS:
        kw[f] = (_from_numpy(arrays[f"{key}.{f}"], dev, spec.fp8_format)
                 if f in meta["fields"] else None)
    return QuantizedLinear(
        spec=spec, out_features=meta["out_features"], in_features=meta["in_features"], **kw
    )


def load_model(path: str, device=None) -> Model:
    """The checkpoint under `path` with its arrays on `device` ("cuda"
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    arrays = np.load(os.path.join(path, "arrays.npz"))
    tree = manifest["tree"]

    def get(key):
        meta = tree[key]
        if meta["kind"] == "quant_linear":
            return _load_lin(key, meta, arrays, dev)
        return _from_numpy(arrays[key], dev)

    params: Dict[str, Any] = {
        "embed": get("embed"),
        "final_norm": get("final_norm"),
        "layers": [],
    }
    if "lm_head" in tree:
        params["lm_head"] = get("lm_head")
    for i in range(manifest["num_layers"]):
        blk = {}
        prefix = f"layers.{i}."
        for key, meta in tree.items():
            if key.startswith(prefix) and key.count(".") == 2:
                blk[key[len(prefix):]] = get(key)
        params["layers"].append(blk)

    cfg = LlamaConfig(**manifest["config"])
    return Model(config=cfg, params=params, family=manifest["family"])


# ---------------------------------------------------------------------------
# calibration journal: per-block resumability
# ---------------------------------------------------------------------------

class CalibrationJournal:
    """Persists quantized blocks + activations as calibration proceeds, so an
    interrupted layer-sequential pass resumes at the last finished block.

    Block i's outputs (the next block's inputs) go to `acts_<i>.npz` before
    `block_<i>.npz` takes its name, each written to a temporary file and
    renamed, and the earlier blocks' activations are removed only after
    that: whichever step an interruption cuts, the last complete block file
    has its outputs beside it. (The JAX package writes one `acts.npz` after
    the block's rename, so an interruption between the two resumes the next
    block from the finished block's inputs.) load_block and load_acts place
    what they read on `device` ("cuda" unless the caller asks for the
    CPU)."""

    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)

    def _blk_path(self, i: int) -> str:
        return os.path.join(self.path, f"block_{i:04d}.npz")

    def _acts_path(self, i: int) -> str:
        return os.path.join(self.path, f"acts_{i:04d}.npz")

    def last_completed(self) -> int:
        done = -1
        while os.path.exists(self._blk_path(done + 1)):
            done += 1
        return done

    @staticmethod
    def _write(path: str, **arrays) -> None:
        tmp = path.replace(".npz", ".tmp.npz")
        np.savez(tmp, **arrays)
        os.replace(tmp, path)

    def save_block(self, i: int, blk: Dict[str, Any], xs=None) -> None:
        arrays: Dict[str, np.ndarray] = {}
        meta: Dict[str, Any] = {}
        for name, node in blk.items():
            if isinstance(node, QuantizedLinear):
                meta[name] = _lin_manifest(node)
                for f in meta[name]["fields"]:
                    arrays[f"{name}.{f}"] = _to_numpy(getattr(node, f), f)
            else:
                meta[name] = {"kind": "array"}
                arrays[name] = _to_numpy(node)
        if xs is not None:
            self._write(self._acts_path(i), **{f"x{j}": _to_numpy(x) for j, x in enumerate(xs)})
        self._write(self._blk_path(i), __meta__=json.dumps(meta), **arrays)
        keep = os.path.basename(self._acts_path(i))
        for f in os.listdir(self.path):
            if f.startswith("acts_") and f != keep:
                os.remove(os.path.join(self.path, f))

    def load_block(self, i: int, device=None) -> Dict[str, Any]:
        dev = resolve_device(device)
        data = np.load(self._blk_path(i), allow_pickle=False)
        meta = json.loads(str(data["__meta__"]))
        blk: Dict[str, Any] = {}
        for name, m in meta.items():
            if m["kind"] == "quant_linear":
                blk[name] = _load_lin(name, m, data, dev)
            else:
                blk[name] = _from_numpy(data[name], dev)
        return blk

    def load_acts(self, device=None):
        """The outputs of the last completed block, or None."""
        p = self._acts_path(self.last_completed())
        if not os.path.exists(p):
            return None
        dev = resolve_device(device)
        data = np.load(p)
        return [_from_numpy(data[f"x{j}"], dev) for j in range(len(data.files))]


# ---------------------------------------------------------------------------
# post-hoc packing: fake-quant model -> packed-kernel model
# ---------------------------------------------------------------------------

def export_packed(model: Model) -> Model:
    """Convert fake-quant linears to packed-int linears: only grid-faithful
    algorithms pack (RTN / GPTQ / AWQ / SmoothQuant / ZeroQuant); SpQR (fp
    outliers) and QuIP / FP8 (no integer grid with qparams) stay fake-quant,
    as in the reference toolbox's QLinear support matrix."""
    from ..core import packing, qparams
    from ..core.qparams import qrange

    def pack_lin(lin):
        if not isinstance(lin, QuantizedLinear):
            return lin
        s = lin.spec
        if (lin.packed is not None or lin.weight is None or s.wbit is None
                or lin.w_scale is None or s.fp8_format is not None):
            return lin
        if s.wbit not in (2, 4, 8):
            return lin
        # verify grid-faithfulness: dequant(int(w)) must reproduce fake_w
        ints = qparams.quantize_to_int(
            lin.weight.to(torch.float32), lin.w_scale, lin.w_zero,
            s.wbit, s.w_qtype, s.w_groupsize, s.w_unsigned,
        )
        if s.w_qtype == "per_group" and s.w_groupsize > 0:
            deq = (ints.reshape(-1, s.w_groupsize).to(torch.float32)
                   - lin.w_zero.reshape(-1, 1)) * lin.w_scale.reshape(-1, 1)
            deq = deq.reshape(lin.out_features, lin.in_features)
        elif s.w_qtype == "per_channel":
            deq = (ints.to(torch.float32) - lin.w_zero.reshape(-1, 1)) * lin.w_scale.reshape(-1, 1)
        else:
            deq = (ints.to(torch.float32) - lin.w_zero.reshape(())) * lin.w_scale.reshape(())
        if not torch.allclose(deq, lin.weight.to(torch.float32), rtol=1e-4, atol=1e-5):
            return lin  # not on the grid (e.g. SpQR outliers): keep fake
        rng = qrange(s.wbit, s.w_unsigned)
        packed = packing.pack_weight_device(ints, s.wbit, rng)
        return lin.replace(weight=None, packed=packed, spec=dataclasses.replace(s, w_packed=True))

    new_layers = []
    for blk in model.params["layers"]:
        new_layers.append({k: pack_lin(v) for k, v in blk.items()})
    params = dict(model.params)
    params["layers"] = new_layers
    if "lm_head" in params:
        params["lm_head"] = pack_lin(params["lm_head"])
    return Model(config=model.config, params=params, family=model.family)
