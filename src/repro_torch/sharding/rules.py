"""Logical-axis -> mesh-axis translation: the port of
``repro.sharding.rules``.

Model code annotates parameters with *logical* axes ("embed", "vocab",
"q_feat", ...).  A :class:`MeshRules` (built from the arch's
``ShardingPlan`` and a mesh) resolves them to partition specs, dropping
any assignment that does not divide the dimension (with GQA, small
vocabularies etc. this is the production-realistic fallback: replicate
what cannot be split).

A mesh is anything that names its axes and their sizes: a
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names``), or an
object with ``.axis_names`` and a ``.shape`` mapping name -> size (the
reference's ``Mesh`` and ``AbstractMesh``, a ``ScenarioMesh``).
:func:`placements` turns a spec into DTensor placements on a
``DeviceMesh``; it takes the place of the reference's ``named()`` and
``spec_tree_to_shardings()``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ShardingPlan


class PartitionSpec(tuple):
    """One entry per tensor dimension: a mesh axis name, a tuple of them,
    or None (replicated).  Normalised as the reference's: a list becomes
    a tuple, a one-axis tuple its axis, an empty tuple None."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# fsdp_tp logical-axis table. Values are mesh axis names (or tuples).
_FSDP_TP = {
    "embed": "data",        # FSDP: shard d_model over data
    "vocab": "model",
    "q_feat": "model",      # flattened q heads x head_dim
    "kv_feat": "model",     # dropped automatically when not divisible
    "heads": "model",
    "mlp": "model",
    "moe_mlp": "model",     # expert FFN hidden (TP moe mode)
    "experts": None,        # overridden to "model" in EP mode
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "layers": None,
    "conv": None,
    None: None,
}


def axis_sizes(mesh) -> dict:
    """Axis name -> size of a ``DeviceMesh`` or a reference-style mesh."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, tuple(mesh.shape)))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def entry_size(sizes: dict, entry) -> int:
    """Devices an entry of a spec spans (1 for None)."""
    if entry is None:
        return 1
    n = 1
    for e in entry if isinstance(entry, tuple) else (entry,):
        n *= sizes[e]
    return n


def placements(mesh, spec) -> tuple:
    """DTensor placements on the ``DeviceMesh`` ``mesh`` for ``spec``:
    ``Shard(d)`` on each mesh dimension that tensor dimension ``d``'s
    entry names, ``Replicate()`` on the others."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for axis in entry if isinstance(entry, tuple) else (entry,):
            out[mesh.mesh_dim_names.index(axis)] = Shard(d)
    return tuple(out)


@dataclass(frozen=True)
class MeshRules:
    plan: ShardingPlan
    mesh: object

    # -- internals ----------------------------------------------------------
    @property
    def axis_names(self) -> tuple:
        return tuple(axis_sizes(self.mesh))

    def axis_size(self, entry) -> int:
        if isinstance(entry, list):
            entry = tuple(entry)
        return entry_size(axis_sizes(self.mesh), entry)

    def _resolve(self, table, axes, shape) -> P:
        out = []
        for ax, dim in zip(axes, shape):
            entry = table.get(ax, None)
            if entry is not None and entry in self.axis_names:
                if dim % self.axis_size(entry) == 0:
                    out.append(entry)
                    continue
            out.append(None)
        return P(*out)

    # -- public -------------------------------------------------------------
    @property
    def data_axes(self):
        """Axes over which the batch is sharded."""
        axes = [a for a in ("pod", "data") if a in self.axis_names]
        if self.plan.mode == "dp_only" and "model" in self.axis_names:
            axes.append("model")
        return tuple(axes)

    @property
    def tp_axis(self) -> Optional[str]:
        if self.plan.mode == "dp_only":
            return None
        return "model" if "model" in self.axis_names else None

    def param(self, axes, shape) -> P:
        if self.plan.mode == "dp_only":
            return P(*([None] * len(shape)))
        table = dict(_FSDP_TP)
        if self.plan.moe_mode == "ep":
            table["experts"] = "model"
            table["moe_mlp"] = None
        return self._resolve(table, axes, shape)

    def opt(self, axes, shape) -> P:
        """Optimizer-state sharding. dp_only gets ZeRO-1 (dim0 sharded)."""
        if self.plan.mode != "dp_only":
            return self.param(axes, shape)
        if not shape:
            return P()
        rest = [None] * (len(shape) - 1)
        flat = self.data_axes
        if shape[0] % self.axis_size(flat) == 0:
            return P(flat, *rest)
        if "data" in self.axis_names and \
                shape[0] % self.axis_size("data") == 0:
            return P("data", *rest)
        return P(*([None] * len(shape)))

    def batch(self, ndim: int, batch_dim: int = 0) -> P:
        spec = [None] * ndim
        spec[batch_dim] = self.data_axes
        return P(*spec)

    def activation(self, *axes) -> P:
        """Activation sharding: 'batch' -> data axes, others via the fsdp
        table minus the FSDP entry (activations are not FSDP-sharded on
        embed)."""
        table = dict(_FSDP_TP)
        table["embed"] = None
        if self.plan.mode == "dp_only":
            table = {k: None for k in table}
        if self.plan.moe_mode == "ep":
            table["experts"] = "model"
        return P(*(self.data_axes if ax == "batch" else table.get(ax, None)
                   for ax in axes))

    def placements(self, spec) -> tuple:
        """``spec`` as DTensor placements on this rule set's
        ``DeviceMesh``."""
        return placements(self.mesh, spec)
