"""Collectives of the tensor- and data-parallel layer, each over an explicit group.

Port of mi_optimize_tpu/parallel/collectives.py (`sharded_xtx`,
`sharded_absmax`, `row_parallel_matmul`). Where the reference takes a mesh
and a global array and lets shard_map cut it, these take the rank's own
shard and its group and reduce with one collective, so a caller composes
them with any sharding it holds.

A group is one of:
  * a `torch.distributed` ProcessGroup: NCCL with one rank a card, gloo in
    the CPU tests. gloo moves CPU tensors only through its point-to-point
    calls, so every gloo collective on a CUDA tensor is staged through host
    memory here;
  * a `LocalGroup` rank (`LocalGroup(n).rank(r)`): ranks that are threads of
    one process sharing one card, whose collective calls meet at a barrier.
    It lets a one-card machine run every rank's real code path (chip_smoke.py
    path t); its transfers are copies on the card.

The group operations the rest of `parallel/` and the TP kernels' wrappers
use: `rank_of`, `size_of`, `all_reduce` (sum or max, in place),
`all_gather`, and the ring step `ring_start` / `ring_wait` (send to the left
neighbour, receive from the right one).
"""
from __future__ import annotations

import threading
from typing import List

import torch
import torch.distributed as dist


class LocalGroup:
    """`size` ranks that are threads of one process; `rank(r)` is rank r's
    handle, passed wherever a group is taken. Every rank must make the same
    collective calls in the same order, as with torch.distributed. On one
    card the threads share the default stream, so each result is written
    after every rank's input was made. `run(fn)` runs fn(rank handle) in one
    thread a rank; a rank that fails, or a collective that waits more than
    `timeout` seconds, breaks the group, so that no rank waits forever."""

    def __init__(self, size: int, timeout: float = 600.0):
        self.size, self.timeout = size, timeout
        self._barrier = threading.Barrier(size, timeout=timeout)
        self._slots: list = [None] * size
        self._result = None
        self._ring = {}
        self._cv = threading.Condition()
        self._broken = False

    def rank(self, r: int) -> "LocalRank":
        if not 0 <= r < self.size:
            raise ValueError(f"rank {r} outside a group of {self.size}")
        return LocalRank(self, r)

    def abort(self) -> None:
        """Break the group: every rank waiting in a collective raises."""
        self._broken = True
        self._barrier.abort()
        with self._cv:
            self._cv.notify_all()

    def run(self, fn) -> list:
        """[fn(self.rank(r)) for each rank], each in a thread of its own;
        re-raises the first rank's failure."""
        out, err = [None] * self.size, []

        def one(r):
            try:
                out[r] = fn(self.rank(r))
            except BaseException as e:  # noqa: BLE001 - re-raised below
                err.append(e)
                self.abort()

        ts = [threading.Thread(target=one, args=(r,)) for r in range(self.size)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        if err:
            raise err[0]
        return out


class LocalRank:
    def __init__(self, group: LocalGroup, rank: int):
        self.group, self.rank, self._seq = group, rank, 0

    def _exchange(self, t):
        """Every rank's t, in rank order (the barrier after the caller's
        reads is the next call's, or `_done`)."""
        g = self.group
        g._slots[self.rank] = t
        g._barrier.wait()
        return g._slots

    def _done(self):
        self.group._barrier.wait()


def rank_of(group) -> int:
    return group.rank if isinstance(group, LocalRank) else dist.get_rank(group)


def size_of(group) -> int:
    return group.group.size if isinstance(group, LocalRank) else dist.get_world_size(group)


def _staged(t: torch.Tensor, group) -> bool:
    """Whether a collective on t goes through host memory: a CUDA tensor on
    a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """t summed (or maxed, op="max") over the group, in place; returns t.
    Every rank gets the same result: a LocalGroup adds the ranks' tensors
    in rank order, NCCL and gloo in their own orders."""
    if op not in ("sum", "max"):
        raise ValueError(f"op must be 'sum' or 'max', not {op!r}")
    if isinstance(group, LocalRank):
        parts = group._exchange(t)
        if group.rank == 0:
            acc = parts[0].clone()
            for p in parts[1:]:
                acc = acc + p if op == "sum" else torch.maximum(acc, p)
            group.group._result = acc
        group._done()
        t.copy_(group.group._result)
        return t
    rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
    if _staged(t, group):
        h = t.cpu()
        dist.all_reduce(h, op=rop, group=group)
        return t.copy_(h)
    dist.all_reduce(t, op=rop, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> List[torch.Tensor]:
    """Every rank's t, in rank order (same shape on every rank)."""
    if isinstance(group, LocalRank):
        out = [p.clone() for p in group._exchange(t)]
        group._done()
        return out
    src = t.cpu() if _staged(t, group) else t.contiguous()
    out = [torch.empty_like(src) for _ in range(size_of(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(t.device) for o in out]


def ring_start(send: torch.Tensor, recv: torch.Tensor, group):
    """Start one ring step: send `send` to the left neighbour (rank - 1) and
    receive the right neighbour's (rank + 1) into `recv`, a tensor of the
    same shape. Returns a handle for `ring_wait`. On NCCL both transfers run
    on its own stream after the work already enqueued, so the caller's next
    launch overlaps them."""
    n, r = size_of(group), rank_of(group)
    if isinstance(group, LocalRank):
        g, key = group.group, group._seq
        group._seq += 1
        with g._cv:
            g._ring[(r, key)] = send.clone()
            g._cv.notify_all()
        return ("local", group, key, recv)
    left = dist.get_global_rank(group, (r - 1) % n)
    right = dist.get_global_rank(group, (r + 1) % n)
    if _staged(send, group):  # gloo's isend/irecv take host memory only
        host = torch.empty(recv.shape, dtype=recv.dtype)
        works = [dist.isend(send.cpu(), left, group=group), dist.irecv(host, right, group=group)]
        return ("host", works, host, recv)
    works = dist.batch_isend_irecv([dist.P2POp(dist.isend, send.contiguous(), left, group),
                                    dist.P2POp(dist.irecv, recv, right, group)])
    return ("dist", works, None, recv)


def ring_wait(handle) -> torch.Tensor:
    """Finish a ring step; returns its `recv` tensor, filled."""
    if handle[0] == "local":
        _, rank, key, recv = handle
        g = rank.group
        src = ((rank.rank + 1) % g.size, key)
        with g._cv:
            if not g._cv.wait_for(lambda: src in g._ring or g._broken, g.timeout) or g._broken:
                g.abort()
                raise RuntimeError("a rank of the LocalGroup failed or timed out")
            t = g._ring.pop(src)
        return recv.copy_(t)
    _, works, host, recv = handle
    for w in works:
        w.wait()
    return recv if host is None else recv.copy_(host)


def sharded_xtx(x_local: torch.Tensor, group) -> torch.Tensor:
    """X^T X in f32 of the rows sharded over the group (each rank holds its
    tokens [t, features]); the result on every rank."""
    xs = x_local.to(torch.float32)
    return all_reduce(xs.t() @ xs, group)


def sharded_absmax(x_local: torch.Tensor, group) -> torch.Tensor:
    """Per-feature max|x| over the token-sharded rows (SmoothQuant's
    statistics); the result on every rank."""
    return all_reduce(x_local.to(torch.float32).abs().amax(dim=0), group, "max")


def row_parallel_matmul(x_local: torch.Tensor, w_local: torch.Tensor, group) -> torch.Tensor:
    """y = x @ w^T with the in-features sharded over the group: each rank
    holds x [M, K/n] and w [N, K/n] of its K slice, computes the f32 partial
    product and all ranks sum them; y in x's dtype."""
    part = torch.matmul(x_local.to(torch.float32), w_local.to(torch.float32).t())
    return all_reduce(part, group).to(x_local.dtype)
