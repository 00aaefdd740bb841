"""The int8-compressed gradient all-reduce over the ``pod`` axis of a mesh
(port of the reference's ``train/distributed.py``).

The mesh's in-pod axes keep their full-precision reductions (DTensor's,
inside each pod's replica); only the pure-DP pod replica sum is
compressed, with the reference's arithmetic step for step in float32:

  1. shared scale: the MAX over the pods of each pod's absmax of the
     *whole* tensor (every shard of it), one float32 scalar a tensor;
  2. ``max(scale, 1e-12) / limit`` with ``limit = max(1, 127 // n_pods)``,
     so an int8 wire sum of the pods cannot wrap;
  3. quantise: ``round`` (half to even, as ``jnp.round``), clip to
     ±limit, int8;
  4. an int8 ``SUM`` all-reduce over the pod group — 4× less inter-pod
     traffic than float32;
  5. dequantise: ``s.float() * scale / n_pods``, cast back to the
     gradient's dtype.

XLA compiles the reference's divisions by the constants ``limit`` and
``n_pods`` as multiplications by their float32 reciprocals (at 4 pods,
``absmax / 31`` and ``absmax * float32(1/31)`` differ in the last bit);
the port multiplies by the same reciprocals, so its result is the
reference's bit for bit.

The caller hands in per-pod partial gradients (``train_step`` gives each
pod its own rows of the batch); the result is their mean on every pod.
"""

from __future__ import annotations

from typing import Any, List

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.params import is_tensor, tensors, tree_map
from repro_torch.parallel.sharding import is_dtensor, mesh_axes


def _local(g: torch.Tensor) -> torch.Tensor:
    return g.to_local() if is_dtensor(g) else g


def _all_reduce_mesh(x: torch.Tensor, mesh, op) -> None:
    """``op`` over every rank of ``mesh``, in place: one all-reduce a mesh
    dim of more than one rank."""
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(x, op=op, group=mesh.get_group(i))


def _reciprocal(n: int) -> float:
    """1/n rounded to float32 (a Python float that float32 tensors take
    as it is)."""
    return float(np.float32(1.0 / n))


def compressed_pod_allreduce(grads: Any, mesh=None) -> Any:
    """Mean-reduce gradients over the pod axis with int8 wire format.

    No-op when there is no mesh or it has no ``pod`` axis (a ``pod`` axis
    of one still quantises, as the reference does).  ``grads`` is a tree
    of tensors or DTensors (each pod's, on its in-pod submesh); the result
    has the same structure, dtypes and placements."""
    if mesh is None or "pod" not in mesh_axes(mesh):
        return grads
    n_pods = mesh_axes(mesh)["pod"]
    limit = max(1, 127 // n_pods)
    leaves = tensors(grads)
    if not leaves:
        return grads
    locals_: List[torch.Tensor] = [_local(g).to(torch.float32)
                                   for g in leaves]
    device = locals_[0].device
    absmax = torch.stack([
        torch.max(torch.abs(g)) if g.numel() else
        torch.zeros((), dtype=torch.float32, device=device)
        for g in locals_])
    # each pod's absmax of the whole tensor, then the MAX over the pods:
    # one MAX over every rank of the mesh
    _all_reduce_mesh(absmax, mesh, dist.ReduceOp.MAX)
    scales = torch.clamp(absmax, min=1e-12) * _reciprocal(limit)
    pod_group = mesh.get_group("pod")
    out = []
    for g, gl, scale in zip(leaves, locals_, scales):
        q = torch.clamp(torch.round(gl / scale), -limit, limit).to(torch.int8)
        if n_pods > 1:
            dist.all_reduce(q, op=dist.ReduceOp.SUM, group=pod_group)
        mean = (q.to(torch.float32) * scale
                * _reciprocal(n_pods)).to(g.dtype)
        if is_dtensor(g):
            from torch.distributed.tensor import DTensor
            mean = DTensor.from_local(mean, g.device_mesh, g.placements,
                                      shape=g.shape, stride=g.stride())
        out.append(mean)
    it = iter(out)
    return tree_map(lambda _: next(it), grads, is_tensor)
