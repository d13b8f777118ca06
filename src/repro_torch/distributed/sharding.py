"""Logical-axis sharding rules (MaxText-style), on torch meshes.

Models annotate tensors with *logical* axis names; a rules table maps
them to mesh axes.  Changing parallelism = changing the table, never the
model code.  The production mesh axes (``launch/mesh.py``):

  pod    DP across pods (grad all-reduce crosses the pod axis only)
  data   FSDP within a pod (params/opt sharded, gathered per layer)
  model  TP / EP within a pod (attention heads or query rows, d_ff,
         vocab and experts; see ``launch/steps.py``)

A mesh is either the port's shape-only ``AbstractMesh`` (no device, no
process group: placement and the dry-run read its shape) or a
``torch.distributed.device_mesh.DeviceMesh``.  Every function reads a
mesh's shape through ``mesh_shape``.  A ``PartitionSpec`` holds one
entry a tensor dim: None, a mesh axis name, or a tuple of mesh axis
names (the dim split over their product, the first axis major, as
DTensor splits a dim over several mesh dims in mesh order).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten

Rules = Dict[str, Union[None, str, Tuple[str, ...]]]

LOGICAL_RULES: Rules = {
    "batch": ("pod", "data"),
    "seq": None,
    "vocab": "model",
    "d_model": None,
    "heads": "model",
    "kv_heads": "model",
    "q_dim": "model",
    "kv_dim": "model",
    "d_ff": "model",
    "experts": "model",
    "d_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "head_dim": None,
    "fsdp": "data",
    "layers": None,
    "enc_seq": None,
    "img_seq": None,
    # context parallelism inside chunked attention: the query-seq dim of
    # the flash accumulator shards over model (kv-head counts rarely
    # divide a 16-way axis; 32k sequences always do)
    "attn_q_seq": "model",
}

_local = threading.local()


def get_rules() -> Rules:
    return getattr(_local, "rules", LOGICAL_RULES)


@contextlib.contextmanager
def set_rules(overrides: Rules):
    """Scoped rule overrides for this thread (e.g. attention flipped to
    sequence-parallel, or ``{"fsdp": None}`` for serving)."""
    base = dict(get_rules())
    base.update(overrides)
    prev = getattr(_local, "rules", None)
    _local.rules = base
    try:
        yield
    finally:
        if prev is None:
            del _local.rules
        else:
            _local.rules = prev


class PartitionSpec(tuple):
    """One entry a tensor dim: None (replicated), a mesh axis name, or a
    tuple of mesh axis names.  ``P("data", None) == ("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, and nothing else: no device and no
    process group (the counterpart of ``jax.sharding.AbstractMesh``)."""
    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{len(self.axis_sizes)} sizes for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, map(int, self.axis_sizes)))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """A mesh's axis names in mesh order (a ``DeviceMesh``'s
    ``mesh_dim_names``, else ``axis_names``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> Dict[str, int]:
    """``{axis: size}`` of an ``AbstractMesh`` or a ``DeviceMesh``."""
    if getattr(mesh, "mesh_dim_names", None) is not None:    # a DeviceMesh
        return dict(zip(mesh.mesh_dim_names, map(int, mesh.shape)))
    return {k: int(v) for k, v in dict(mesh.shape).items()}


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def logical_to_mesh_spec(logical_axes: Tuple[Optional[str], ...],
                         mesh=None) -> PartitionSpec:
    """Map a tuple of logical axis names to a PartitionSpec, dropping
    mesh axes that don't exist in ``mesh`` (lets the same model code run
    on one device and on the 512-chip production mesh) and any mesh
    axis an earlier dim already took."""
    rules = get_rules()
    mesh_axes = set(mesh_axis_names(mesh)) if mesh is not None else None
    spec = []
    used = set()
    for ax in logical_axes:
        target = rules.get(ax) if ax is not None else None
        if target is None:
            spec.append(None)
            continue
        multi = isinstance(target, tuple)
        if not multi:
            target = (target,)
        present = tuple(t for t in target
                        if (mesh_axes is None or t in mesh_axes)
                        and t not in used)
        used.update(present)
        if not present:
            spec.append(None)
        elif multi:
            # multi-axis rules keep tuple form even when the mesh drops
            # all but one axis: ("pod","data") -> ("data",) — a sharded
            # dim stays visibly distinct from a rule that named one axis
            spec.append(present)
        else:
            spec.append(present[0])
    return P(*spec)


def legalize_spec(spec, shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """``spec`` with, per dim of ``shape``, the mesh axes that do not
    divide it dropped (e.g. kv_heads=8 on a 16-way model axis, or
    Whisper's odd vocab 51865): axes are kept in order while the product
    of the kept ones divides the dim.  A dim left with one axis names
    it, with none is None; entries past ``shape`` are dropped."""
    sizes = mesh_shape(mesh)
    new = []
    for i, dim in enumerate(shape):
        keep, prod = [], 1
        for a in _axes(spec[i] if i < len(spec) else None):
            if dim % (prod * sizes[a]) == 0:
                keep.append(a)
                prod *= sizes[a]
        new.append(tuple(keep) if len(keep) > 1
                   else (keep[0] if keep else None))
    return P(*new)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (the counterpart of JAX's ``NamedSharding``)."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        """DTensor placements, one a mesh dim: ``Shard(i)`` on each mesh
        dim that tensor dim ``i`` is split over, ``Replicate()``
        elsewhere.  DTensor splits a dim over several mesh dims in mesh
        order, so a spec naming them in another order raises."""
        from torch.distributed.tensor import Replicate, Shard
        names = mesh_axis_names(self.mesh)
        out = [Replicate()] * len(names)
        for i, entry in enumerate(self.spec):
            idx = [names.index(a) for a in _axes(entry)]
            if idx != sorted(idx):
                raise ValueError(
                    f"dim {i} is split over {_axes(entry)}, not in the "
                    f"mesh's axis order {names}: DTensor cannot place it")
            for j in idx:
                out[j] = Shard(i)
        return tuple(out)

    def shard_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """The local shape of a tensor of ``shape`` under this sharding
        (each split dim must divide)."""
        sizes = mesh_shape(self.mesh)
        out = list(shape)
        for i, entry in enumerate(self.spec):
            n = math.prod(sizes[a] for a in _axes(entry))
            if out[i] % n:
                raise ValueError(f"dim {i} of {tuple(shape)} does not "
                                 f"divide into {n} ({self.spec})")
            out[i] //= n
        return tuple(out)


def named_sharding(mesh, *logical_axes: Optional[str]) -> NamedSharding:
    return NamedSharding(mesh, logical_to_mesh_spec(tuple(logical_axes), mesh))


# ----------------------------------------------------------------------
# the ambient mesh (the counterpart of JAX's ``with mesh:``)
# ----------------------------------------------------------------------
@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` this thread's ambient mesh inside the block."""
    prev = getattr(_local, "mesh", None)
    _local.mesh = mesh
    try:
        yield mesh
    finally:
        _local.mesh = prev


def current_mesh():
    """This thread's ambient mesh, or None."""
    return getattr(_local, "mesh", None)


def shard_constraint(x, *logical_axes: Optional[str], mesh=None):
    """Redistribute a DTensor to the logical rules' placements on
    ``mesh`` (the ambient mesh when None), with the axes that do not
    divide a dim dropped (``legalize_spec``).  The argument itself comes
    back when it is a plain tensor, when there is no mesh, or when the
    mesh has one device; any other failure raises."""
    if type(x) is torch.Tensor:       # the models' hot path: no import
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    active = mesh if mesh is not None else current_mesh()
    if active is None or math.prod(mesh_shape(active).values()) <= 1:
        return x
    spec = legalize_spec(logical_to_mesh_spec(tuple(logical_axes), active),
                         tuple(x.shape), active)
    return x.redistribute(active, NamedSharding(active, spec).placements)


#: Mesh axes that carry data residency — a corpus shard lives on one
#: coordinate of their product (DP across pods, FSDP/data within one).
#: The query runtime's PlacementMap derives its host count from these.
RESIDENCY_AXES: Tuple[str, ...] = ("pod", "data")


def data_host_count(mesh) -> int:
    """Number of data-resident hosts a mesh implies: the product of the
    residency axes present in it (``pod`` x ``data``; axes absent from
    the mesh contribute 1).  Placement only needs the shape, so an
    ``AbstractMesh`` serves as well as a ``DeviceMesh``."""
    shape = mesh_shape(mesh)
    return math.prod(shape.get(ax, 1) for ax in RESIDENCY_AXES)


def mesh_axis_size(axis: str) -> Optional[int]:
    """Size of ``axis`` in the ambient mesh (None outside one, or where
    the mesh has no such axis)."""
    mesh = current_mesh()
    return None if mesh is None else mesh_shape(mesh).get(axis)


# ----------------------------------------------------------------------
# placing trees of tensors
# ----------------------------------------------------------------------
def _packed(x) -> bool:
    """A NamedTuple with static fields (a q8 moment) is one leaf here."""
    return isinstance(x, tuple) and hasattr(type(x), "_static")


def place_tree(tree, shardings):
    """Every tensor of ``tree`` as a DTensor placed by the
    ``NamedSharding`` in the same place of ``shardings`` (no
    communication: each rank holds the whole tensor and keeps its
    shard).  A subtree where ``shardings`` holds one sharding (a q8
    moment's codes and scales) is replicated; a leaf that is no tensor
    (a decode state's ``length``, the host's count) stays as it is."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    def place(x, sh):
        if isinstance(x, (int, float)):
            return x
        if not isinstance(x, (tuple, list, dict)):
            return distribute_tensor(x, sh.mesh, sh.placements,
                                     src_data_rank=None)
        rep = [Replicate()] * len(mesh_axis_names(sh.mesh))
        return tree_map(lambda t: distribute_tensor(t, sh.mesh, rep,
                                                    src_data_rank=None), x)

    sh_leaves = tree_leaves(shardings)
    subtrees = tree_leaves(tree, is_leaf=_packed)
    if len(sh_leaves) != len(subtrees):
        raise ValueError(f"{len(subtrees)} leaves against "
                         f"{len(sh_leaves)} shardings")
    return tree_unflatten(tree, [place(x, sh) for x, sh in
                                 zip(subtrees, sh_leaves)])


def full_tree(tree):
    """Every DTensor of ``tree`` as its whole tensor: the local tensor
    itself where it is whole (a mesh of one device), else gathered
    (every rank must call).  Plain leaves stay as they are."""
    from torch.distributed.tensor import DTensor

    def whole(x):
        if not isinstance(x, DTensor):
            return x
        local = x.to_local()
        return local if local.shape == x.shape else x.full_tensor()
    return tree_map(whole, tree)
