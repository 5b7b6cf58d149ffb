"""Checkpoint/restore cost model for grid events: the port of
``repro.workload.ckpt_cost``.

A reserve activation that preempts training is checkpoint-safe only if
the state was saved first, and resuming replays the restore; both cost
wall-clock that the Tier-3 selector prices.  The model is seeded from
the real ``repro_torch.ckpt`` artifacts: a manifest's leaf shapes and
dtypes give the logical state size byte for byte (equal to
:func:`tree_bytes` of the live tree), and sequential save / restore
bandwidths turn bytes into seconds.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch._tree import leaves

_MANIFEST = "manifest.json"


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return int(np.asarray(leaf).nbytes)


def tree_bytes(tree: Any) -> int:
    """Logical (uncompressed) byte size of a tree's tensor and array
    leaves."""
    return sum(_nbytes(leaf) for leaf in leaves(tree))


def manifest_bytes(manifest: dict) -> int:
    """Logical byte size recorded in a checkpoint manifest, from its
    per-leaf ``shape``/``dtype`` entries (not the compressed shard
    files), so it equals :func:`tree_bytes` of the tree that was saved."""
    total = 0
    for leaf in manifest["leaves"]:
        n = int(np.prod(leaf["shape"], dtype=np.int64)) if leaf["shape"] \
            else 1
        total += n * _itemsize(leaf["dtype"])
    return int(total)


def _itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize


def checkpoint_bytes(ckpt_dir: str) -> int:
    """Logical state size of an on-disk checkpoint (its manifest)."""
    with open(os.path.join(ckpt_dir, _MANIFEST)) as f:
        return manifest_bytes(json.load(f))


@dataclass(frozen=True)
class CkptCostModel:
    """Bytes -> seconds for the save/restore halves of a grid event.
    Defaults are a sequential filesystem's order of magnitude (the zlib-1
    sharded writer); override with measured numbers per site."""

    write_bps: float = 2e9       # sustained checkpoint write bandwidth
    read_bps: float = 4e9        # restore read bandwidth
    overhead_s: float = 2.0      # barrier + manifest + process overhead

    def save_seconds(self, nbytes: int) -> float:
        return self.overhead_s + nbytes / self.write_bps

    def restore_seconds(self, nbytes: int) -> float:
        return self.overhead_s + nbytes / self.read_bps

    def grid_event_seconds(self, nbytes: int) -> float:
        """Dead time one grid event charges: save before the shed plus
        restore on resume."""
        return self.save_seconds(nbytes) + self.restore_seconds(nbytes)


def grid_event_cost_s(state: Any,
                      model: CkptCostModel = CkptCostModel()) -> float:
    """Per-event checkpoint dead time for a live training state."""
    return model.grid_event_seconds(tree_bytes(state))
