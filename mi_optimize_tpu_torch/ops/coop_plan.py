"""The work plan of a 4-bit GEMV phase inside a cooperative whole-model
kernel (csrc/batch_gemv.cuh for the batched kernel, csrc/flat_gemv.cuh for
the flat one).

Output columns go in warp strips; a tile is `ws` strips (1, 2, 4 or 8: the
block's 8 warps, the 8 // ws warps of a strip splitting the tile's K again);
K is cut into `splits` ranges of whole groups, split s covering groups
[s*ng/S, (s+1)*ng/S); the items, tiles x splits, are dealt out over the
cooperative grid. `best_plan` searches every (ws, splits), puts the plans
that leave at most GRID_IDLE of a wave's blocks idle first (where any plan
can), and ranks the rest by the kernel's own key: `ops/model_fused.py`
(`gemv_plan`) and `ops/model_flat.py` (`flat_plan`) pass theirs. A plan
depends on shapes only, so every launch takes the same plan and gives the
same bits.
"""
from __future__ import annotations

import functools

import torch

COOP_PER_SM = 2    # blocks an SM of the cooperative grid (decode_common.cuh)
H100_SMS = 132     # the plan's SM count on the CPU
GRID_IDLE = 0.05   # the share of a wave's blocks a plan may leave idle


@functools.lru_cache(maxsize=None)
def sm_count(dev) -> int:
    """The SM count of the card `dev`."""
    return torch.cuda.get_device_properties(dev).multi_processor_count


def best_plan(nstrips: int, ng: int, blocks: int, rank, split: bool = True) -> tuple:
    """(ws, splits) for a GEMV of `nstrips` warp strips over `ng` groups on
    `blocks` blocks. rank(ws, splits, most, waves, idle) gives a plan's key
    (`most`: groups of its largest split; `idle`: the blocks without an item
    in its last wave), or None for a plan the kernel does not take; the
    least key wins among the plans that fill the grid. split=False allows
    no K split."""
    best = None
    for ws in (8, 4, 2, 1):
        ntiles = -(-nstrips // ws)
        for splits in (range(1, ng + 1) if split else (1,)):
            most = -(-ng // splits)
            items = ntiles * splits
            waves = -(-items // blocks)
            idle = waves * blocks - items
            key = rank(ws, splits, most, waves, idle)
            if key is None:
                continue
            key = (idle > GRID_IDLE * waves * blocks,) + tuple(key)
            if best is None or key < best[0]:
                best = (key, ws, splits)
    return best[1], best[2]
