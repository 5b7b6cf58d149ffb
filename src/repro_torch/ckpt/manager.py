"""Sharded, manifest-versioned checkpointing with elastic restore: the port
of ``repro.ckpt.manager``, with the same on-disk layout, so a checkpoint
written by either package restores in the other.

Layout (one directory per step):

    <root>/step_00000123.tmp/      # staged, then atomically renamed
        manifest.json              # step, shard count, per-leaf path,
                                   # shape, dtype and pieces, extra
        shard_000/leaf_0007.bin    # zlib-compressed raw bytes per
        ...                        # (leaf, shard)
    <root>/step_00000123/          # committed

Leaves are taken in JAX's flattening order (dict keys sorted) and named
by the reference's path spelling (``0/layers/wq``, ``1/.mu/embed``), so
the manifests of the two packages for the same state are identical.
Leaves with at least ``n_shards`` rows are split along dim 0 into
``n_shards`` pieces; restore concatenates the pieces and places each
leaf on the caller's ``device``, so a checkpoint written on one device
restores on another -- or, with ``shardings``, as a DTensor on a
``DeviceMesh`` (the elastic restore: a checkpoint written at one
data-parallel width restores at another, sharded state as replicated and
the reverse).  Leaves are written whole: sharded state is gathered on
every rank first (``sharding/fsdp.py::full_leaves``), and one rank
writes.  The atomic rename makes a
crash mid-save invisible.  The pieces are compressed and decompressed on
a pool of host threads (zlib lets go of the GIL): level-1 zlib on
float32 weights runs at tens of MB/s a core, so one thread would take
minutes for a model of a few GB.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch._tree import leaves_with_paths, unflatten_like
from repro_torch.sharding import fsdp
from repro_torch.sharding.rules import placements

_MANIFEST = "manifest.json"


def _pool() -> ThreadPoolExecutor:
    return ThreadPoolExecutor(max_workers=os.cpu_count() or 1)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a numpy array of its bytes, and its dtype's name
    (bfloat16, which numpy lacks, travels as its 16-bit pattern)."""
    if fsdp.is_sharded(leaf):
        raise ValueError("a checkpoint leaf must be whole: gather sharded "
                         "state on every rank first (fsdp.full_leaves)")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.frombuffer(raw, np.int16).reshape(
            shape).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, np.dtype(dtype)).reshape(
        shape).copy())


def _steps(root: str) -> list[int]:
    return sorted(int(d.split("_")[1]) for d in os.listdir(root)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save_checkpoint(root: str, step: int, tree: Any, *,
                    n_shards: int = 4, extra: Optional[dict] = None) -> str:
    """Write ``tree`` (params / optimiser state) at ``step``.  Returns the
    committed directory."""
    final = os.path.join(root, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "n_shards": n_shards, "leaves": [],
                "extra": extra or {}}
    writes = []
    for i, (path, leaf) in enumerate(leaves_with_paths(tree)):
        arr, dtype = _to_numpy(leaf)
        meta = {"index": i, "path": "/".join(path), "shape": list(arr.shape),
                "dtype": dtype}
        manifest["leaves"].append(meta)
        if arr.ndim == 0 or arr.shape[0] < n_shards:
            pieces = [(0, arr)]
        else:
            pieces = list(enumerate(np.array_split(arr, n_shards, axis=0)))
        for s, piece in pieces:
            d = os.path.join(tmp, f"shard_{s:03d}")
            os.makedirs(d, exist_ok=True)
            writes.append((os.path.join(d, f"leaf_{i:04d}.bin"), piece))
            meta.setdefault("pieces", []).append(
                {"shard": s, "shape": list(piece.shape)})

    def write(job):
        fname, piece = job
        with open(fname, "wb") as f:
            f.write(zlib.compress(piece.tobytes(), level=1))

    with _pool() as pool:
        list(pool.map(write, writes))

    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)  # atomic commit
    return final


def _shardings_like(tree_like: Any, shardings: Any) -> list:
    """The ``(DeviceMesh, spec)`` pair of each leaf of ``tree_like``, in
    leaf order, from ``shardings`` of the same structure."""
    if isinstance(tree_like, dict):
        return [x for k in sorted(tree_like)
                for x in _shardings_like(tree_like[k], shardings[k])]
    if isinstance(tree_like, tuple) and hasattr(tree_like, "_fields"):
        return [x for f in tree_like._fields
                for x in _shardings_like(getattr(tree_like, f),
                                         getattr(shardings, f))]
    if isinstance(tree_like, (tuple, list)):
        return [x for t, s in zip(tree_like, shardings)
                for x in _shardings_like(t, s)]
    return [] if tree_like is None else [shardings]


def restore_checkpoint(root: str, tree_like: Any, *,
                       step: Optional[int] = None, device="cuda",
                       shardings: Any = None) -> tuple[Any, int, dict]:
    """Restore into the structure of ``tree_like`` (leaf count and shapes
    checked), every leaf a tensor on ``device`` in the dtype it was saved
    with.  ``shardings``, a tree of ``(DeviceMesh, spec)`` pairs of
    ``tree_like``'s structure, restores each leaf instead as a DTensor on
    its mesh with ``rules.placements(mesh, spec)`` -- this rank's shard
    cut from the leaf, no communication -- and a None pair as a plain
    tensor on ``device``.  Returns (tree, step, extra)."""
    dev = resolve_device(device)
    if step is None:
        steps = _steps(root)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {root}")
        step = steps[-1]
    path = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)

    like = list(leaves_with_paths(tree_like))
    if len(like) != len(manifest["leaves"]):
        raise ValueError(f"leaf count mismatch: have {len(like)}, "
                         f"checkpoint {len(manifest['leaves'])}")
    def read(job):
        i, meta, pc = job
        d = os.path.join(path, f"shard_{pc['shard']:03d}")
        with open(os.path.join(d, f"leaf_{i:04d}.bin"), "rb") as f:
            return _from_bytes(zlib.decompress(f.read()), meta["dtype"],
                               pc["shape"])

    jobs = [(i, meta, pc) for i, meta in enumerate(manifest["leaves"])
            for pc in meta["pieces"]]
    with _pool() as pool:
        flat = iter(list(pool.map(read, jobs)))
    if shardings is not None:
        places = iter(_shardings_like(tree_like, shardings))
    out = []
    for meta, (_, leaf) in zip(manifest["leaves"], like):
        pieces = [next(flat) for _ in meta["pieces"]]
        t = pieces[0] if len(pieces) == 1 else torch.cat(pieces, 0)
        t = t.reshape(meta["shape"])
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else \
            np.shape(leaf)
        if tuple(t.shape) != tuple(want):
            raise ValueError(f"{meta['path']}: checkpoint shape "
                             f"{tuple(t.shape)}, expected {tuple(want)}")
        pair = None if shardings is None else next(places)
        if pair is None:
            out.append(t.to(dev))
        else:
            mesh, spec = pair
            pl = placements(mesh, spec)
            loc = fsdp.local_chunk(t, mesh, pl).to(mesh.device_type,
                                                   copy=True)
            out.append(fsdp.from_local(loc.contiguous(), mesh, pl, t.shape))
    return unflatten_like(tree_like, out), step, manifest.get("extra", {})


@dataclass
class CheckpointManager:
    """Keeps the last ``keep`` checkpoints; save/restore convenience."""

    root: str
    keep: int = 3
    n_shards: int = 4

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> str:
        os.makedirs(self.root, exist_ok=True)
        p = save_checkpoint(self.root, step, tree, n_shards=self.n_shards,
                            extra=extra)
        self._gc()
        return p

    def restore(self, tree_like: Any, step: Optional[int] = None,
                shardings: Any = None, device="cuda"):
        return restore_checkpoint(self.root, tree_like, step=step,
                                  device=device, shardings=shardings)

    def latest_step(self) -> Optional[int]:
        if not os.path.isdir(self.root):
            return None
        steps = _steps(self.root)
        return steps[-1] if steps else None

    def _gc(self) -> None:
        for s in _steps(self.root)[:-self.keep]:
            shutil.rmtree(os.path.join(self.root, f"step_{s:08d}"),
                          ignore_errors=True)
