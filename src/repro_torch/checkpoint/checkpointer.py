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
  device the caller names (in place of the reference's shardings).
* **Keep-K GC**: older complete checkpoints beyond ``keep`` are removed
  after a successful save.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike

_SEP = "\x1e"


def _items(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """``(key, leaf)`` in the reference's flatten order; ``None`` is an
    empty subtree, as in JAX."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from _items(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _items(sub, path + (str(i),))
    elif tree is not None:
        yield _SEP.join(path), tree


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


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A copy of ``leaf`` in host memory (bf16 as float32) and the dtype
    name the manifest records."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        name = str(t.dtype).replace("torch.", "")
        if t.dtype == torch.bfloat16:
            t = t.float()
        arr = t.cpu().numpy()
        return (arr.copy() if t.device.type == "cpu" else arr), name
    arr = np.array(leaf)
    return arr, str(arr.dtype)


def _snapshot(tree) -> Dict[str, Tuple[np.ndarray, str]]:
    return {k: _host(v) for k, v in _items(tree)}


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree) -> None:
        """Snapshot to host and write in the background."""
        self.wait()
        host = _snapshot(tree)

        def write():
            try:
                self._write(step, host)
            except BaseException as e:       # raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def save(self, step: int, tree) -> None:
        self._write(step, _snapshot(tree))

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

    def restore(self, step: int, like, device: DeviceLike = None):
        """Restore into the structure of ``like`` (a tree of tensors or
        numpy arrays): each leaf in its ``like`` leaf's dtype, a tensor on
        ``device`` (``like``'s own device when None)."""
        path = self.dir / f"step_{step:010d}"
        manifest = json.loads((path / "manifest.json").read_text())
        flat_like = dict(_items(like))
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
            if isinstance(want, torch.Tensor):
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
