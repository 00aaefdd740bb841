"""Parameter descriptor trees (port of the reference's ``models/params.py``).

Every model module declares its parameters once as a tree of
:class:`ParamDef` (shape + logical sharding axes + initialiser): nested
dicts and lists, as in the reference.  The tree then materialises three
ways:

* ``init_params``       — real tensors on an explicit device, seeded;
* ``abstract_params``   — ``meta``-device tensors (shapes, no bytes);
* ``params_from_numpy`` — the reference package's parameter tree, carried
  over as numpy arrays and held to the descriptors leaf by leaf.

With a ``mesh`` (a ``DeviceMesh`` named by the production axes) the
first and last return DTensors with each leaf's spec's placements
(:func:`shard_params`): every rank builds the same global values and
keeps its own shard, so a sharded run starts where a single-device run
starts.

Leaves are visited in the reference's order (dict keys sorted, lists in
order), so leaf ``i`` here is leaf ``i`` of ``jax.tree.flatten``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from .weights import WeightsError


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones
    scale: Optional[float] = None  # None → 1/sqrt(fan_in)

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


def _is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_items(tree, is_leaf: Callable[[Any], bool] = _is_def,
               path: str = "") -> Iterator[Tuple[str, Any]]:
    """``(path, leaf)`` of a tree of dicts and lists in the reference's
    leaf order; a path reads ``blocks/0/mix/wq``."""
    if is_leaf(tree):
        yield path, tree
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_items(tree[key], is_leaf, f"{path}/{key}"
                                  if path else str(key))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from tree_items(sub, is_leaf, f"{path}/{i}" if path
                                  else str(i))
    elif tree is not None:
        raise TypeError(f"{path or 'tree'}: not a dict, list or leaf "
                        f"({type(tree).__name__})")


def is_tensor(x) -> bool:
    return isinstance(x, torch.Tensor)


def tensors(tree) -> List[torch.Tensor]:
    """The tensor leaves of a tree, in ``tree_items`` order."""
    return [leaf for _, leaf in tree_items(tree, is_tensor)]


def tree_map(fn: Callable[[Any], Any], tree,
             is_leaf: Callable[[Any], bool] = _is_def):
    """``tree`` with every leaf replaced by ``fn(leaf)``, the leaves
    visited in ``tree_items`` order."""
    if is_leaf(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], is_leaf) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, is_leaf) for v in tree)
    return tree


def _leaf_seed(seed: int, index: int) -> int:
    """A generator seed forked from ``(seed, leaf index)``."""
    return int(np.random.SeedSequence([seed, index]).generate_state(
        1, np.uint64)[0] & ((1 << 63) - 1))


# a leaf in a dtype other than float32 is drawn this many float32 values
# at a time (whole rows of its leading axis), so no float32 copy of a
# large leaf is held beside it (moonshot's expert stacks: 35 GB a leaf)
DRAW_CHUNK = 1 << 27


def shard_params(params, defs, mesh):
    """``params`` (full tensors, alike on every rank) as DTensors on
    ``mesh``, each leaf with the placements of its logical axes' spec
    (``parallel.sharding``); no communication."""
    from repro_torch.parallel.sharding import distribute, logical_to_spec
    leaves = iter(d for _, d in tree_items(defs))
    return tree_map(lambda t: distribute(t, mesh, logical_to_spec(
        next(leaves).logical, mesh)), params, is_tensor)


def init_params(defs, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                device: DeviceLike = None, mesh=None):
    """Materialise real parameter tensors on ``device`` (the card unless
    named): zeros, ones, or a normal draw × ``scale`` (1/√fan_in when
    None), each normal leaf from its own ``torch.Generator`` on the
    device, seeded from ``(seed, leaf index)``.  Drawn in float32: a
    float32 leaf at once; a leaf in another ``dtype`` into a tensor of
    that dtype, ``DRAW_CHUNK`` values (whole rows of the leading axis) at
    a time from the same generator, each chunk cast as it is drawn."""
    device = resolve_device(device)
    index = iter(range(param_leaves(defs)))

    def make(d: ParamDef) -> torch.Tensor:
        i = next(index)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=device)
        scale = d.scale
        if scale is None:
            fan_in = d.shape[0] if len(d.shape) > 1 else d.shape[-1]
            scale = 1.0 / np.sqrt(max(1, fan_in))
        gen = torch.Generator(device=device)
        gen.manual_seed(_leaf_seed(seed, i))
        if dtype == torch.float32 or len(d.shape) < 2:
            x = torch.randn(d.shape, generator=gen, dtype=torch.float32,
                            device=device)
            return x.mul_(float(scale)).to(dtype)
        out = torch.empty(d.shape, dtype=dtype, device=device)
        rows = max(1, DRAW_CHUNK // int(np.prod(d.shape[1:])))
        for lo in range(0, d.shape[0], rows):
            part = out[lo:lo + rows]
            part.copy_(torch.randn(part.shape, generator=gen,
                                   dtype=torch.float32,
                                   device=device).mul_(float(scale)))
        return out

    params = tree_map(make, defs)
    return params if mesh is None else shard_params(params, defs, mesh)


def abstract_params(defs, dtype: torch.dtype = torch.bfloat16):
    """``meta``-device tensors of each leaf's shape — zero allocation."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype,
                                          device="meta"), defs)


def logical_tree(defs):
    return tree_map(lambda d: d.logical, defs)


def param_leaves(defs) -> int:
    return sum(1 for _ in tree_items(defs))


def param_count(defs) -> int:
    return sum(int(np.prod(d.shape)) for _, d in tree_items(defs))


def param_bytes(defs, bytes_per_param: int = 2) -> int:
    return param_count(defs) * bytes_per_param


def _array_items(arrays) -> List[Tuple[str, Any]]:
    return list(tree_items(arrays, lambda x: not isinstance(
        x, (dict, list, tuple))))


def params_from_numpy(defs, arrays, *, device: DeviceLike = None,
                      dtype: torch.dtype = torch.float32, mesh=None):
    """The reference's parameter tree as numpy (nested dicts and lists,
    stacked leaves with their leading repeats axis) → the port's tree of
    the same structure on ``device`` in ``dtype``.  Every leaf is held to
    ``defs``: present, no extras, the right shape; a fault raises
    :class:`~repro_torch.models.weights.WeightsError` with
    ``weights-missing``, ``weights-unexpected`` or ``weights-shape``
    naming the leaf's path."""
    device = resolve_device(device)
    want = dict(tree_items(defs))
    have = dict(_array_items(arrays))
    missing = sorted(set(want) - set(have))
    if missing:
        raise WeightsError(f"missing parameters {missing}", name=missing[0],
                           constraint="weights-missing")
    extra = sorted(set(have) - set(want))
    if extra:
        raise WeightsError(f"unexpected parameters {extra}", name=extra[0],
                           constraint="weights-unexpected")
    for path, d in want.items():
        shape = tuple(np.shape(have[path]))
        if shape != tuple(d.shape):
            raise WeightsError(f"{path} has shape {shape}, the model needs "
                               f"{tuple(d.shape)}", name=path,
                               constraint="weights-shape")

    def carry(path: str) -> torch.Tensor:
        # a copy on every device: training updates its parameters in place,
        # and must not write through to the caller's arrays
        arr = np.ascontiguousarray(np.asarray(have[path], np.float32))
        return torch.from_numpy(arr).to(device=device, dtype=dtype,
                                        copy=True)

    paths = iter(want)
    params = tree_map(lambda d: carry(next(paths)), defs)
    return params if mesh is None else shard_params(params, defs, mesh)
