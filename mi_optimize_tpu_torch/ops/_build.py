"""Build the CUDA sources under csrc/ with nvcc and load them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface
(no PyTorch headers, so a build takes seconds). Libraries go to
`build/torch_kernels/` at the repository root; the file name carries a hash of
the sources and flags, so an edited source is rebuilt and a stale library is
never loaded. Beside each library lies ptxas's report of its kernels
(`-Xptxas -v`: registers and spill bytes), read by `ptxas_log`. Building
happens at first use; `build_all` starts one nvcc per source, all at once.

Every C entry point returns `cudaGetLastError()` after its launch; `check`
raises on anything but 0, since a refused launch never runs and a later
synchronize does not report it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "torch_kernels")
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17", "-shared",
         "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = ("dequant_matmul", "block_fused", "model_flat", "model_fused", "model_mega4",
           "paged_attention", "decode_attention", "mlp_fused", "w4a8_matmul")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with "
                           "the CUDA toolkit (CUDA_HOME or /usr/local/cuda)")
    return found


def _lib_path(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def _log_path(lib: str) -> str:
    """ptxas's report beside the library at `lib`."""
    return lib[:-len(".so")] + ".ptxas.txt"


def _start(name: str):
    """Start nvcc for one source unless its library exists. Returns
    (process, temp path, final path) or None."""
    out = _lib_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc_path(), *FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu:\n{log}")
    fd, tmp_log = tempfile.mkstemp(suffix=".txt", dir=BUILD_DIR)
    with os.fdopen(fd, "w") as f:
        f.write(log)
    os.replace(tmp_log, _log_path(out))  # before the library: a library has its report
    os.replace(tmp, out)


def build_all() -> None:
    """Compile every source in parallel (one nvcc each)."""
    with _lock:
        jobs = {n: _start(n) for n in SOURCES}
        for n in SOURCES:
            _finish(n, jobs[n])


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(_lib_path(name))
            _libs[name] = lib
        return lib


def ptxas_log(name: str) -> str:
    """ptxas's report from the build of csrc/<name>.cu, building it first if
    needed."""
    with _lock:
        _finish(name, _start(name))
    with open(_log_path(_lib_path(name))) as f:
        return f.read()


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {err}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
