"""Async, atomic checkpointing (port of the reference's
``checkpoint/checkpointer.py``, in its on-disk format).

* **Atomic**: a checkpoint is written to ``step_N.tmp/`` and renamed to
  ``step_N/`` only when complete — a crash mid-write can never corrupt the
  restore set (the ``.tmp`` is ignored and GC'd).
* **Async**: ``save_async`` copies every leaf to host memory at once (the
  train step updates its tensors in place, so the copy is taken before the
  next step runs) and writes in a background thread; ``wait()`` joins it
  and raises what the write raised.
* **Format**: one ``leaf_NNNNN.npy`` a leaf (bf16 stored as float32) and a
  ``manifest.json`` of each leaf's file, dtype and shape, keyed by the
  leaf's path: dict keys, list indices and ``NamedTuple`` field names
  (``AdamWState``'s ``step``/``mu``/``nu``, ``Moment8``'s ``q``/``scale``)
  joined with ``\\x1e`` — the keys ``jax.tree_util.keystr(simple=True)``
  gives the reference, so a checkpoint written by either package restores
  in the other.
* **Restore** into the structure and dtypes of a ``like`` tree, on a
  device the caller names, or placed by a tree of shardings
  (``parallel.sharding.NamedSharding``: a mesh and placements) as the
  reference's ``restore`` places its arrays — under any mesh, whatever
  mesh wrote the checkpoint.  A DTensor ``like`` leaf with no sharding
  given keeps its own mesh and placements.
* **On a mesh** ``save`` gathers every DTensor leaf to rank 0, which
  writes: one copy of each shard is sent to rank 0 from a rank of rank
  0's mesh (every rank saves; no other rank builds the full tensor or
  keeps a copy).  ``wait`` ends with a barrier, so no rank reads the
  directory before the write is done.
* **Keep-K GC**: older complete checkpoints beyond ``keep`` are removed
  after a successful save.
"""

from __future__ import annotations

import itertools
import json
import pathlib
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike
from repro_torch.parallel.sharding import NamedSharding, is_dtensor

_SEP = "\x1e"


def _items(tree, leaf_type=None, path: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` in the reference's flatten order; ``None`` is an
    empty subtree, as in JAX.  ``leaf_type``: a tuple type taken whole
    (a sharding)."""
    if leaf_type is not None and isinstance(tree, leaf_type):
        yield _SEP.join(path), tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], leaf_type, path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), leaf_type, path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _items(sub, leaf_type, path + (str(i),))
    elif tree is not None:
        yield _SEP.join(path), tree


def _place(arr: np.ndarray, dtype: torch.dtype, sharding: NamedSharding):
    """The full array as a DTensor on ``sharding``'s mesh: every rank read
    it, and each keeps its shard (no communication)."""
    from torch.distributed.tensor import distribute_tensor
    mesh = sharding.mesh
    dev = (torch.device("cuda", torch.cuda.current_device())
           if mesh.device_type == "cuda" else torch.device(mesh.device_type))
    full = torch.from_numpy(arr).to(device=dev, dtype=dtype)
    return distribute_tensor(full, mesh, sharding.placements,
                             src_data_rank=None)


def _rebuild(tree, leaves: Dict[str, Any], path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, path + (str(k),))
                for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, name), leaves,
                                     path + (name,))
                            for name in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(sub, leaves, path + (str(i),))
                          for i, sub in enumerate(tree))
    if tree is None:
        return None
    return leaves[_SEP.join(path)]


def _shard_box(shape, mesh, placements, coord):
    """(offsets, sizes) of the shard at mesh coordinate ``coord``: each
    ``Shard(d)``, in mesh-dim order, cuts dim ``d`` as ``torch.chunk``
    does, as DTensor does."""
    off, size = [0] * len(shape), list(shape)
    for i, p in enumerate(placements):
        if p.is_shard():
            d, n = p.dim % len(shape), mesh.size(i)
            step = -(-size[d] // n)
            lo = min(coord[i] * step, size[d])
            off[d] += lo
            size[d] = min(step, size[d] - lo)
    return off, size


def _gather0(t) -> Optional[torch.Tensor]:
    """DTensor ``t``'s full tensor on global rank 0, None on every other
    rank.  The holders are the ranks of rank 0's mesh at rank 0's
    coordinate on every mesh dim that does not shard ``t``: each sends
    its shard to rank 0, which puts it in place (a rank outside rank 0's
    mesh, as another pod's, sends nothing)."""
    mesh, places = t.device_mesh, t.placements
    if any(p.is_partial() for p in places):
        raise ValueError("a Partial DTensor leaf cannot be saved")
    ranks = mesh.mesh
    at0 = (ranks == 0).nonzero()
    if len(at0) == 0:
        return None
    c0 = at0[0].tolist()
    holders = [(int(ranks[c]), c) for c in itertools.product(
        *map(range, ranks.shape))
        if all(c[i] == c0[i] for i, p in enumerate(places)
               if not p.is_shard())]
    local, me = t.to_local().detach(), dist.get_rank()
    if me != 0:
        if me in (r for r, _ in holders) and local.numel():
            dist.send(local.contiguous(), dst=0)
        return None
    full = torch.empty(t.shape, dtype=local.dtype, device=local.device)
    for r, c in holders:
        off, size = _shard_box(t.shape, mesh, places, c)
        box = full[tuple(slice(o, o + n) for o, n in zip(off, size))]
        if r == 0:
            box.copy_(local)
        elif box.numel():
            part = torch.empty(size, dtype=local.dtype, device=local.device)
            dist.recv(part, src=r)
            box.copy_(part)
    return full


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory (bf16 as float32) and the dtype
    name the manifest records (on rank 0 for a DTensor leaf)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if is_dtensor(t):
            t = _gather0(t)
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().numpy()
        return (arr.copy() if t.device.type == "cpu" else arr), name
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree, keep: bool = True
              ) -> Dict[str, Tuple[np.ndarray, str]]:
    """Host copies of every leaf (every rank sends its DTensors' shards to
    rank 0; a rank that does not write keeps nothing)."""
    if keep:
        return {k: _host(v) for k, v in _items(tree)}
    for _, v in _items(tree):
        if is_dtensor(v):
            _gather0(v.detach())
    return {}


def _group() -> bool:
    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.writer = not _group() or dist.get_rank() == 0
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if _group():
            dist.barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree) -> None:
        """Snapshot to host and write in the background."""
        self.wait()
        host = _snapshot(tree, self.writer)
        if not self.writer:
            return

        def write():
            try:
                self._write(step, host)
            except BaseException as e:       # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def save(self, step: int, tree) -> None:
        host = _snapshot(tree, self.writer)
        if self.writer:
            self._write(step, host)
        if _group():
            dist.barrier()

    # ------------------------------------------------------------------
    def _write(self, step: int,
               host: Dict[str, Tuple[np.ndarray, str]]) -> None:
        final = self.dir / f"step_{step:010d}"
        tmp = self.dir / f"step_{step:010d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": {}}
        for i, (key, (arr, dtype)) in enumerate(sorted(host.items())):
            fname = f"leaf_{i:05d}.npy"
            store = arr
            if arr.dtype.kind not in "fiub?":
                store = arr.astype(np.float32)
            np.save(tmp / fname, store)
            manifest["leaves"][key] = {
                "file": fname, "dtype": dtype, "shape": list(arr.shape)}
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)                      # atomic commit
        self._gc()

    def _gc(self) -> None:
        done = self.complete_steps()
        for s in done[:-self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
        for tmp in self.dir.glob("*.tmp"):
            shutil.rmtree(tmp, ignore_errors=True)

    # ------------------------------------------------------------------
    def complete_steps(self) -> List[int]:
        steps = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            steps.append(int(p.name.split("_")[1]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.complete_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like, shardings=None,
                device: DeviceLike = None):
        """Restore into the structure of ``like`` (a tree of tensors or
        numpy arrays): each leaf in its ``like`` leaf's dtype, a tensor on
        ``device`` (``like``'s own device when None) — or, where
        ``shardings`` (a tree like ``like`` of ``NamedSharding``) or a
        DTensor ``like`` leaf places it, a DTensor on that mesh, each rank
        keeping its own shard."""
        path = self.dir / f"step_{step:010d}"
        manifest = json.loads((path / "manifest.json").read_text())
        flat_like = dict(_items(like))
        flat_shard = dict(_items(shardings, NamedSharding)) \
            if shardings is not None else {}
        out: Dict[str, Any] = {}
        for key, meta in manifest["leaves"].items():
            if key not in flat_like:
                continue                      # dropped leaf (fwd compat)
            arr = np.load(path / meta["file"])
            want = flat_like[key]
            if not isinstance(want, torch.Tensor):
                want = np.asarray(want)
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {arr.shape} != "
                    f"expected {tuple(want.shape)}")
            sharding = flat_shard.get(key)
            if sharding is None and is_dtensor(want):
                sharding = NamedSharding(want.device_mesh, want.placements)
            if sharding is not None:
                out[key] = _place(arr, want.dtype, sharding)
            elif isinstance(want, torch.Tensor):
                dev = want.device if device is None else torch.device(device)
                if dev.type == "meta":
                    raise ValueError(f"leaf {key!r}: name a device to "
                                     f"restore a meta tensor onto")
                out[key] = torch.from_numpy(arr).to(device=dev,
                                                    dtype=want.dtype)
            else:
                out[key] = arr.astype(want.dtype)
        missing = set(flat_like) - set(out)
        if missing:
            raise ValueError(f"checkpoint missing leaves: {sorted(missing)[:5]}")
        return _rebuild(like, out)
