"""What the port's kernel scripts share, on one NVIDIA GPU: a copy of csrc/
with %globaltimer stamps put into a kernel, built beside the package's own
build; copies of csrc/ built side by side, with ptxas's rows of their
instances; `torch.sum` over as many bytes as a kernel reads, after the same
L2 flush; and a window's walls and device time by kernel.

Imported by scripts/torch_{decode,paged,flat}_phases.py,
torch_{decode,flat}_variants.py and torch_{decode_attention,paged}_times.py;
it runs nothing by itself. Its callers put the checkout whose chip_smoke.py
and package they run on sys.path first.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAXB = 8192  # blocks a stamp holds, numbered as PT_BLOCK numbers them


def stamp_prelude(dims, macros="") -> str:
    """C++ that declares the stamps g_pt[dims] (u64), gtime() (%globaltimer),
    smid(), PT_(k) (thread 0 of each block writes the time to
    g_pt[k][PT_BLOCK]) and PT_SM(k) (its SM + 1 there), then `macros`, and
    the library's extern "C" mi_timers(out) and mi_timers_clear()."""
    decl = "".join(f"[{d}]" for d in dims)
    return f"""
__device__ unsigned long long g_pt{decl};
__device__ __forceinline__ unsigned long long gtime() {{
  unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t)); return t; }}
__device__ __forceinline__ unsigned smid() {{
  unsigned s; asm volatile("mov.u32 %0, %%smid;" : "=r"(s)); return s; }}
#define PT_BLOCK (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define PT_(k) if (threadIdx.x == 0) g_pt[k][PT_BLOCK] = gtime();
#define PT_SM(k) if (threadIdx.x == 0) g_pt[k][PT_BLOCK] = smid() + 1;
{macros}
extern "C" int mi_timers(void* out) {{
  return (int)cudaMemcpyFromSymbol(out, g_pt, sizeof(g_pt));
}}
extern "C" int mi_timers_clear() {{
  static unsigned long long zero{decl};
  return (int)cudaMemcpyToSymbol(g_pt, zero, sizeof(g_pt));
}}
"""


def stamped_copy(name, stamped, after, prelude, anchors) -> str:
    """Copy the package's csrc/ to build/<name>/csrc; in its file `stamped`,
    put `prelude` after the first `after` and replace each (line, stamped
    line) of `anchors`, each found once after that point. Returns the copy's
    directory."""
    from mi_optimize_tpu_torch.ops import _build

    src = os.path.join(HERE, "build", name, "csrc")
    shutil.rmtree(src, ignore_errors=True)
    shutil.copytree(_build.CSRC, src)
    path = os.path.join(src, stamped)
    head, body = open(path).read().split(after, 1)
    for old, new in anchors:
        if body.count(old) != 1:
            raise RuntimeError(f"{stamped} changed: no single line {old.strip()!r} to stamp")
        body = body.replace(old, new)
    with open(path, "w") as f:
        f.write(head + after + prelude + body)
    return src


def start_build(src_dir, source, lib):
    """nvcc of src_dir/source into `lib` with the package's flags, started."""
    from mi_optimize_tpu_torch.ops import _build

    return subprocess.Popen([_build.nvcc_path(), *_build.FLAGS, "-o", lib,
                             os.path.join(src_dir, source)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def finish_build(proc, what) -> str:
    """nvcc's log (ptxas's report in it) once `proc` has ended well."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {what}:\n{log[-8000:]}")
    return log


def build_copies(dirs, source, name, pattern, label):
    """Build `source` of each csrc copy in `dirs` (one nvcc each, all
    started together) into build/<name>/<i>.so and log ptxas's rows of the
    instances that match `pattern` (chip_smoke.ptxas_rows). Returns
    [(loaded library, rows)] in the order of `dirs`."""
    import chip_smoke

    out = os.path.join(HERE, "build", name)
    os.makedirs(out, exist_ok=True)
    libs = [os.path.join(out, f"{i}.so") for i in range(len(dirs))]
    procs = [start_build(os.path.abspath(d), source, lib) for d, lib in zip(dirs, libs)]
    res = []
    for d, lib, proc in zip(dirs, libs, procs):
        rows = chip_smoke.ptxas_rows(finish_build(proc, f"{d}/{source}"), pattern, label)
        for r in rows:
            chip_smoke.log(f"  {d}: {r['instance']}: {r.get('registers')} registers, "
                           f"{r['spill_stores']}/{r['spill_loads']} bytes spilled, "
                           f"{r['stack']} bytes stack")
        res.append((ctypes.CDLL(lib), rows))
    return res


def read_stamps(lib, dims):
    """The stamps of `lib`'s last launches, u64 nanoseconds [dims]."""
    import numpy as np

    t = np.zeros(dims, np.uint64)
    if lib.mi_timers(t.ctypes.data_as(ctypes.c_void_p)):
        raise RuntimeError("reading the stamps failed")
    return t


def clear_stamps(lib):
    if lib.mi_timers_clear():
        raise RuntimeError("clearing the stamps failed")


def sum_ms(nbytes, reps, flush, timer=None):
    """`timer` (chip_smoke.time_ms by default) of torch.sum over a float32
    tensor of `nbytes` bytes: a library read of as many bytes as a kernel
    reads, after the same L2 flush."""
    import torch

    import chip_smoke

    t = torch.zeros(-(-nbytes // 4), dtype=torch.float32, device="cuda")
    return (timer or chip_smoke.time_ms)(lambda: t.sum(), reps, flush)


def device_window(run, walls=5):
    """run() once, then `walls` timed runs (host clock, each ending in a
    synchronize) and one under torch.profiler: (the walls in ms, {kernel:
    its device ms in the profiled run})."""
    import torch

    run()
    torch.cuda.synchronize()
    ms = []
    for _ in range(walls):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + e.self_device_time_total / 1e3
    return ms, by_name
