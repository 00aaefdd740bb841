"""Sharding rules: logical axes → mesh axes → DTensor placements (port of
the reference's ``parallel/sharding.py``).

The production mesh is ``(data, model)`` per pod (16×16) with an optional
leading pure-DP ``pod`` axis.  Parameters are sharded over *both* axes
(FSDP over ``data`` + tensor parallelism over ``model``); activations put
batch on ``(pod, data)`` and the hidden/head dimension on ``model``.

Logical axis names used by the model code:

  "fsdp"    → ("data",)            ZeRO-3 style parameter sharding
  "tp"      → ("model",)           tensor-parallel dimension
  "batch"   → ("pod", "data")      data-parallel batch
  "seq"     → ("model",)           sequence sharding (KV caches, SP norms)
  "expert"  → ("data",)            expert parallelism (opt-in)
  None      → replicated

A spec (:class:`PartitionSpec`, ``P``) is a tuple with one entry per
tensor dim — ``None``, a mesh axis name, or a tuple of axis names — entry
for entry the reference's ``jax.sharding.PartitionSpec``.  The spec
functions take any mesh that names its axes and their sizes: an abstract
:class:`MeshSpec` (no process group: the 16×16 and 2×16×16 specs are
computed in one process) or a ``torch.distributed`` ``DeviceMesh`` built
with ``mesh_dim_names``.  :func:`placements` turns a spec into DTensor
placements on a ``DeviceMesh``: ``Shard(d)`` on each mesh dim that tensor
dim ``d`` names, else ``Replicate()``.  A multi-axis entry such as
``("pod", "data")`` lists its axes in mesh order, so DTensor's
left-to-right sharding of one tensor dim over several mesh dims gives
GSPMD's major-to-minor layout.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Any, Dict, Iterator, NamedTuple, Optional, Sequence, Tuple

import numpy as np

RULES = {
    "fsdp": ("data",),
    "tp": ("model",),
    "batch": ("pod", "data"),
    "seq": ("model",),
    "expert": ("data",),
    "vocab": ("model",),
}


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None``, an axis name or a tuple of axis
    names (a tuple subclass, so a tree walk can tell a spec from the
    tuples that hold specs)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def is_spec(x) -> bool:
    return isinstance(x, PartitionSpec)


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh geometry (configs, the launcher, and the abstract
    mesh the spec functions take)."""

    shape: Tuple[int, ...]
    axes: Tuple[str, ...]

    def build(self):
        """The ``DeviceMesh`` of this geometry over the default process
        group, whose world size must be :attr:`n_devices`."""
        from repro_torch.launch.mesh import make_mesh
        return make_mesh(self.shape, self.axes)

    @property
    def n_devices(self) -> int:
        return int(np.prod(self.shape))

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return self.axes


SINGLE_POD = MeshSpec((16, 16), ("data", "model"))
MULTI_POD = MeshSpec((2, 16, 16), ("pod", "data", "model"))


def smoke_mesh() -> MeshSpec:
    """The 1-device geometry with the production axis names: every spec
    resolves to replicated."""
    return MeshSpec((1, 1), ("data", "model"))


def mesh_axes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` in mesh order, of a :class:`MeshSpec` or a
    ``DeviceMesh`` built with ``mesh_dim_names``."""
    if isinstance(mesh, MeshSpec):
        return dict(zip(mesh.axes, mesh.shape))
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to take specs")
    return dict(zip(names, tuple(mesh.shape)))


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_axes(mesh))


def _entry(axes: Sequence[str]):
    axes = tuple(axes)
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def logical_to_spec(logical: Sequence[Optional[str]], mesh) -> P:
    """Resolve logical axis names to a spec for ``mesh``: mesh axes the
    mesh lacks are dropped, and so are trailing ``None``s."""
    names = set(mesh_axes(mesh))
    out = []
    for ax in logical:
        if ax is None:
            out.append(None)
            continue
        out.append(_entry(m for m in RULES[ax] if m in names))
    while out and out[-1] is None:
        out.pop()
    return P(*out)


def fit_spec(spec: P, shape: Sequence[int], mesh) -> P:
    """``spec`` over every dim of ``shape``, each entry keeping the prefix
    of its axes whose sizes divide the dim (the reference's
    ``_sanitize_spec``: batch 1, the 8-bit moments' shrunken scales)."""
    sizes = mesh_axes(mesh)
    fixed = []
    for dim, entry in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if entry is None:
            fixed.append(None)
            continue
        keep, size = [], 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            if dim % (size * sizes[a]) == 0:
                keep.append(a)
                size *= sizes[a]
        fixed.append(_entry(keep))
    return P(*fixed)


def walk(tree, fn, is_leaf):
    """``tree`` with ``fn`` applied to every leaf: dicts (keys sorted),
    lists, tuples, NamedTuples and dataclasses are containers."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: walk(tree[k], fn, is_leaf) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(walk(v, fn, is_leaf) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(walk(v, fn, is_leaf) for v in tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: walk(getattr(tree, f.name), fn,
                                           is_leaf)
                             for f in dataclasses.fields(tree)})
    return tree


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and not is_spec(x) and all(
        a is None or isinstance(a, str) for a in x)


def spec_tree(logical_tree, mesh):
    """Map a tree of logical-axis tuples to specs."""
    return walk(logical_tree, lambda lg: logical_to_spec(lg, mesh),
                 _is_logical)


class NamedSharding(NamedTuple):
    """A ``DeviceMesh`` and the DTensor placements of a tensor on it."""
    mesh: Any
    placements: Tuple[Any, ...]


def placements(spec: P, mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim of more than one rank that tensor dim ``d`` names, else
    ``Replicate()`` (a shard over one rank is the whole tensor: so a 1×1
    mesh places every tensor whole, and DTensor runs the single-device
    operations)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axis_names(mesh)
    sizes = tuple(mesh.shape)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [names.index(a) for a in axes]
        if order != sorted(order):
            raise ValueError(f"spec entry {entry} is not in mesh order "
                             f"{names}")
        for i in order:
            if out[i] != Replicate():
                raise ValueError(f"mesh axis {names[i]} shards two dims "
                                 f"of {spec}")
            if sizes[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def sharding_tree(logical_tree, mesh):
    """A tree of :class:`NamedSharding` (the placements of each spec)."""
    return walk(spec_tree(logical_tree, mesh),
                 lambda s: NamedSharding(mesh, placements(s, mesh)), is_spec)


def divisible(n: int, mesh, axis: str) -> bool:
    sizes = mesh_axes(mesh)
    if axis not in sizes:
        return True
    return n % sizes[axis] == 0


# ---------------------------------------------------------------------------
# DTensors
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def spec_of(x) -> P:
    """The spec of a DTensor's ``Shard`` placements (its ``Partial`` and
    ``Replicate`` dims read as replicated)."""
    from torch.distributed.tensor import Shard
    names = x.device_mesh.mesh_dim_names
    entries = [[] for _ in range(x.ndim)]
    for name, pl in zip(names, x.placements):
        if isinstance(pl, Shard):
            entries[pl.dim].append(name)
    return P(*(_entry(e) for e in entries))


def local_shape(shape: Sequence[int], places, mesh) -> Tuple[int, ...]:
    """The local shard's shape of a tensor of ``shape`` under ``places``
    (every sharded dim divides evenly, as ``fit_spec`` keeps it)."""
    from torch.distributed.tensor import Shard
    out = list(shape)
    for size, pl in zip(tuple(mesh.shape), places):
        if isinstance(pl, Shard):
            if out[pl.dim] % size:
                raise ValueError(f"dim {pl.dim} of {tuple(shape)} does not "
                                 f"split over {size}")
            out[pl.dim] //= size
    return tuple(out)


def shard_range(x, dim: int) -> Tuple[int, int]:
    """``[start, stop)`` of dim ``dim`` that this rank's shard of the
    DTensor ``x`` holds (even shards, mesh dims major to minor)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    index, count = 0, 1
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            size = mesh.size(i)
            index = index * size + mesh.get_local_rank(i)
            count *= size
    n = x.shape[dim] // count
    return index * n, (index + 1) * n


def zeros_on(shape: Sequence[int], spec: P, mesh, dtype, device):
    """A zero DTensor of global ``shape`` with ``spec``'s placements, each
    rank allocating only its shard."""
    import torch
    from torch.distributed.tensor import DTensor
    places = placements(fit_spec(spec, shape, mesh), mesh)
    local = torch.zeros(local_shape(shape, places, mesh), dtype=dtype,
                        device=device)
    return DTensor.from_local(local, mesh, places)


def distribute(x, mesh, spec: P):
    """The full tensor ``x``, which every rank holds alike, as a DTensor
    with ``spec``'s placements: each rank keeps its own shard (no
    communication)."""
    from torch.distributed.tensor import distribute_tensor
    places = placements(fit_spec(spec, x.shape, mesh), mesh)
    return distribute_tensor(x, mesh, places, src_data_rank=None)


_IN_SCOPE = contextvars.ContextVar("mesh_scope", default=False)


@contextlib.contextmanager
def mesh_scope(*trees) -> Iterator[None]:
    """A scope in which plain tensors meet DTensors as replicated ones
    (DTensor's ``implicit_replication``: the constants of RoPE, masks and
    aranges), when a leaf of ``trees`` is a DTensor; else no scope.
    Scopes nest: only the outermost enters and leaves
    ``implicit_replication``, whose exit would end an enclosing one."""
    found = []
    for tree in trees:
        walk(tree, found.append, is_dtensor)
    if _IN_SCOPE.get() or not any(is_dtensor(x) for x in found):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    token = _IN_SCOPE.set(True)
    try:
        with implicit_replication():
            yield
    finally:
        _IN_SCOPE.reset(token)
