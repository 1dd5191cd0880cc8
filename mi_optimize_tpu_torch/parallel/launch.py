"""Process-group start-up, the global mesh, and a launcher of rank processes.

Port of mi_optimize_tpu/parallel/launch.py. torchrun (or any launcher) sets
RANK, WORLD_SIZE and MASTER_ADDR/MASTER_PORT in each process; the mesh puts
the "model" (tensor-parallel) dimension on the cards of one host, where
NVLink carries its all-reduces, and the "data" dimension across hosts:

    from mi_optimize_tpu_torch.parallel import launch, shard_model
    launch.initialize_multihost()              # one process: returns
    mesh = launch.global_mesh(n_model=4)       # 4-way TP a host, DP across
    model = shard_model(model, mesh)

Unlike the reference, which logs a failed start-up and goes on as one
process, `initialize_multihost` raises when the environment asks for
several processes and the group cannot be made.

`spawn` runs a function in `world` local processes joined by a
torch.distributed group (gloo by default: the CPU tests; chip_smoke.py
and the one-card runs), each rank's result pickled back to the caller.
Run as `python -m mi_optimize_tpu_torch.parallel.launch <job dir> <rank>`
it is one of those processes.
"""
from __future__ import annotations

import importlib
import logging
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch
import torch.distributed as dist

log = logging.getLogger(__name__)

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize_multihost(init_method: Optional[str] = None, world_size: Optional[int] = None,
                         rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Join the process group. With no arguments it reads torchrun's RANK,
    WORLD_SIZE and MASTER_ADDR; with none of them set (and no arguments) it
    returns False: one process. The backend defaults to NCCL, one rank a
    card (pass backend="gloo" for the CPU). Raises if the group cannot be
    made. Returns whether a group of several processes is up."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    given = (init_method, world_size, rank)
    if all(v is None for v in given) and not any(k in os.environ for k in _ENV):
        log.info("no RANK/WORLD_SIZE/MASTER_ADDR: one process")
        return False
    backend = backend or "nccl"
    kw = {k: v for k, v in zip(("init_method", "world_size", "rank"), given) if v is not None}
    dist.init_process_group(backend, **kw)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dist.get_rank()))
                              % torch.cuda.device_count())
    log.info("process group up: rank %d of %d (%s)", dist.get_rank(), dist.get_world_size(),
             backend)
    return dist.get_world_size() > 1


def _local_ranks() -> int:
    """Ranks a host runs: torchrun's LOCAL_WORLD_SIZE, else its cards."""
    n = os.environ.get("LOCAL_WORLD_SIZE")
    return int(n) if n else max(torch.cuda.device_count(), 1)


def global_mesh(n_model: Optional[int] = None, device_type: Optional[str] = None):
    """("data", "model") DeviceMesh over every rank of the job. n_model
    defaults to the ranks of one host, so tensor parallelism stays inside a
    host and data parallelism spans hosts."""
    from .sharding import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    n_model = min(n_model or _local_ranks(), world)
    if world % n_model:
        raise ValueError(f"{world} ranks are not divisible by n_model={n_model}")
    return make_mesh(n_model=n_model, n_data=world // n_model, device_type=device_type)


def per_host_batch_slice(global_batch: int, mesh=None) -> slice:
    """The rows of a global batch this rank feeds: by its "data"
    coordinate on `mesh`, else by its rank in the job (one rank: all)."""
    if mesh is not None:
        n, i = mesh.size(mesh.mesh_dim_names.index("data")), mesh.get_local_rank("data")
    elif dist.is_initialized():
        n, i = dist.get_world_size(), dist.get_rank()
    else:
        n, i = 1, 0
    per = global_batch // n
    return slice(i * per, (i + 1) * per)


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(target: str, world: int, backend: str = "gloo", timeout: float = 600.0,
          threads: int = 1, **kwargs) -> list:
    """Run `target` ("package.module:function", in a module that imports no
    JAX) as `world` processes joined by a `backend` group on localhost:
    function(rank, world, **kwargs) in each, after init_process_group.
    Returns the results in rank order (each pickled back); raises with the
    end of a rank's output if any rank fails or the run exceeds `timeout`
    seconds. Every process it starts is ended before it returns."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    job = tempfile.mkdtemp(prefix="mi_spawn_")
    with open(os.path.join(job, "job.pkl"), "wb") as f:
        pickle.dump(dict(target=target, world=world, backend=backend, threads=threads,
                         init=f"tcp://127.0.0.1:{free_port()}", kwargs=kwargs), f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    procs, logs = [], []
    try:
        for r in range(world):
            lf = open(os.path.join(job, f"rank{r}.log"), "w")
            logs.append(lf)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "mi_optimize_tpu_torch.parallel.launch", job, str(r)],
                cwd=root, env=env, stdout=lf, stderr=subprocess.STDOUT))
        end = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            if failed or time.monotonic() > end:
                break
            time.sleep(0.05)
        bad = [r for r, p in enumerate(procs) if p.poll() != 0]
        if bad:
            r = bad[0]
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            with open(os.path.join(job, f"rank{r}.log")) as f:
                tail = f.read()[-6000:]
            raise RuntimeError(f"{target}: rank {r} of {world} failed (exit "
                               f"{procs[r].returncode}) or ran past {timeout} s:\n{tail}")
        out = []
        for r in range(world):
            with open(os.path.join(job, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lf in logs:
            lf.close()
        for fn in os.listdir(job):
            os.unlink(os.path.join(job, fn))
        os.rmdir(job)


def _worker(job: str, rank: int) -> None:
    with open(os.path.join(job, "job.pkl"), "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(spec["threads"])
    mod, fn = spec["target"].split(":")
    fn = getattr(importlib.import_module(mod), fn)
    dist.init_process_group(spec["backend"], init_method=spec["init"],
                            world_size=spec["world"], rank=rank)
    try:
        res = fn(rank, spec["world"], **spec["kwargs"])
        tmp = os.path.join(job, f"result{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(res, f)
        os.replace(tmp, os.path.join(job, f"result{rank}.pkl"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]))
