"""Training step factory: microbatched gradient accumulation + AdamW (port
of the reference's ``train/train_step.py``).

The global batch is split into ``microbatches`` along the batch axis and
taken one microbatch at a time; gradients accumulate in
``grad_accum_dtype`` (float32 by default, bf16 for the ≥100B
configurations), and the loss and metrics are averaged.  Parameters are
leaf tensors with ``requires_grad``; :func:`make_train_step` returns a
plain function on them whose metrics stay on the device until the caller
reads them.

On a mesh (``make_train_step(..., mesh=mesh)``) the parameters are
DTensors on the in-pod ``(data, model)`` mesh (``mesh["data", "model"]``
where the mesh has a ``pod`` axis), each pod a replica holding them, and
the batch its own rows (``data.pipeline.make_global_batch``).  DTensor
carries the in-pod reductions; each gradient is brought to its
parameter's placements.  The pod sum is explicit, the reference's "pure-DP
pod replica sum": :func:`~repro_torch.train.distributed.
compressed_pod_allreduce` under ``grad_compression="int8_pod"``, else a
float32 mean all-reduce over the pod group; the loss and metrics are
averaged over the pods the same way.  Without a ``pod`` axis
``"int8_pod"`` is the reference's no-op.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.config import ModelConfig
from repro_torch.models.params import is_tensor, tensors, tree_map
from repro_torch.models.transformer import encode, forward
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import is_dtensor, mesh_axes, mesh_scope

from .distributed import compressed_pod_allreduce
from .losses import chunked_softmax_xent

Batch = Dict[str, torch.Tensor]
Metrics = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    loss_chunk: int = 512
    moe_aux_weight: float = 1e-2
    grad_accum_dtype: torch.dtype = torch.float32
    opt: adamw.AdamWConfig = dataclasses.field(
        default_factory=adamw.AdamWConfig)
    grad_compression: Optional[str] = None    # None | "int8_pod"


def loss_fn(params, cfg: ModelConfig, batch: Batch, train_cfg: TrainConfig
            ) -> Tuple[torch.Tensor, Metrics]:
    enc_out = None
    if cfg.encoder_layers:
        enc_out = encode(params, cfg, batch["frames"])
    prefix = batch.get("prefix_embed")
    h, aux = forward(params, cfg, batch["tokens"], enc_out=enc_out,
                     prefix_embed=prefix)
    if prefix is not None:
        h = h[:, prefix.shape[1]:]        # loss over token positions only
    nll, acc = chunked_softmax_xent(params, cfg, h, batch["labels"],
                                    chunk=train_cfg.loss_chunk)
    loss = nll + train_cfg.moe_aux_weight * aux
    return loss, {"nll": nll, "accuracy": acc, "moe_aux": aux}


def _like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (a ``Partial``
    sum completed, a replicated one sharded as the parameter is)."""
    if is_dtensor(g) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _micro(x: torch.Tensor, i: int, m: int) -> torch.Tensor:
    """Microbatch ``i`` of ``m`` of a batch leaf: rows ``[i·n/m,
    (i+1)·n/m)``; of a batch-sharded DTensor, that part of each rank's own
    rows (the same mean over equal microbatches, no rows moved)."""
    if not is_dtensor(x):
        size = x.shape[0] // m
        return x[i * size:(i + 1) * size]
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    size = local.shape[0] // m
    if local.shape[0] % m:
        raise ValueError(f"a shard of {local.shape[0]} rows does not split "
                         f"into {m} microbatches")
    return DTensor.from_local(local[i * size:(i + 1) * size], x.device_mesh,
                              x.placements)


def _plain(x: torch.Tensor) -> torch.Tensor:
    return x.full_tensor() if is_dtensor(x) else x


def make_grad_fn(cfg: ModelConfig, train_cfg: TrainConfig
                 ) -> Callable[[Any, Batch],
                               Tuple[torch.Tensor, Metrics, Any]]:
    """``grad_fn(params, batch) → (loss, metrics, grads)``: the grads a
    tree like ``params``, accumulated over the microbatches (in
    ``grad_accum_dtype`` where there are several), loss and metrics their
    mean."""
    if cfg.causal_skip:
        # the reference's chunk skip has dynamic trip counts and is not
        # reverse-differentiable there: training uses the masked schedule
        cfg = dataclasses.replace(cfg, causal_skip=False)

    def single(params, batch):
        leaves = tensors(params)
        with mesh_scope(params):
            loss, metrics = loss_fn(params, cfg, batch, train_cfg)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        grads = [_like(g, p) for g, p in zip(grads, leaves)]
        it = iter(grads)
        tree = tree_map(lambda _: next(it), params, is_tensor)
        return _plain(loss.detach()), {k: _plain(v.detach())
                                       for k, v in metrics.items()}, tree

    def added(params, batch, acc: list):
        """One microbatch's (loss, metrics), its gradients added into
        ``acc`` (a leaf a parameter, in ``grad_accum_dtype``; None before
        the first microbatch, which then takes a cast copy: 0 + g,
        exactly).  Each leaf's gradient is cast and added as the backward
        produces it (a post-accumulate hook) and then dropped, so a
        microbatch's float32 gradients are never held all at once beside
        the accumulator: one card holds mixtral-8x22b's 2-layer step only
        so."""
        leaves = tensors(params)
        dtype = train_cfg.grad_accum_dtype

        def hook(i):
            def add(p):
                g = _like(p.grad, p)
                p.grad = None
                if acc[i] is None:
                    acc[i] = g.to(dtype, copy=True)
                else:
                    acc[i].add_(g.to(dtype))
            return add

        for p in leaves:
            p.grad = None
        handles = [p.register_post_accumulate_grad_hook(hook(i))
                   for i, p in enumerate(leaves)]
        try:
            with mesh_scope(params):
                loss, metrics = loss_fn(params, cfg, batch, train_cfg)
                loss.backward()
        finally:
            for h in handles:
                h.remove()
        for i, p in enumerate(leaves):      # a leaf the loss does not reach
            if acc[i] is None:
                acc[i] = torch.zeros_like(p, dtype=dtype)
        return _plain(loss.detach()), {k: _plain(v.detach())
                                       for k, v in metrics.items()}

    def accumulated(params, batch):
        m = train_cfg.microbatches
        n = next(iter(batch.values())).shape[0]
        if n % m:
            raise ValueError(f"a batch of {n} does not split into {m} "
                             f"microbatches")
        acc = [None] * len(tensors(params))
        loss_acc = met_acc = None
        for i in range(m):
            mb = {k: _micro(v, i, m) for k, v in batch.items()}
            loss, metrics = added(params, mb, acc)
            if loss_acc is None:
                loss_acc, met_acc = loss, dict(metrics)
            else:
                loss_acc = loss_acc + loss
                met_acc = {k: met_acc[k] + metrics[k] for k in met_acc}
        inv = 1.0 / m
        for a in acc:
            a.mul_(inv)
        it = iter(acc)
        return loss_acc * inv, {k: v * inv for k, v in met_acc.items()}, \
            tree_map(lambda _: next(it), params, is_tensor)

    return accumulated if train_cfg.microbatches > 1 else single


def param_mesh(mesh):
    """The mesh a pod's replica holds its parameters on: ``mesh`` without
    its ``pod`` axis (None for None)."""
    if mesh is None or "pod" not in mesh_axes(mesh):
        return mesh
    return mesh[tuple(a for a in mesh.mesh_dim_names if a != "pod")]


def _pod_mean(tree, mesh):
    """The float32 mean over the pod group of every leaf, in place."""
    group, n = mesh.get_group("pod"), mesh_axes(mesh)["pod"]
    for g in tensors(tree):
        local = g.to_local() if is_dtensor(g) else g
        buf = local.to(torch.float32)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        local.copy_(buf / n)
    return tree


def make_train_step(cfg: ModelConfig, train_cfg: TrainConfig, mesh=None):
    """Returns ``train_step(params, opt_state, batch) → (params, opt_state,
    metrics)``.  ``params`` and the moments of ``opt_state`` are updated in
    place (``adamw.apply_updates``) and returned; ``metrics`` (loss, nll,
    accuracy, moe_aux, grad_norm, lr) are 0-d tensors on the device.
    ``mesh``: the ``DeviceMesh`` the parameters live on (with its ``pod``
    axis, if any)."""
    if train_cfg.grad_compression not in (None, "int8_pod"):
        raise ValueError(f"unknown grad_compression "
                         f"{train_cfg.grad_compression!r}")
    grad_fn = make_grad_fn(cfg, train_cfg)
    pods = mesh is not None and "pod" in mesh_axes(mesh)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = grad_fn(params, batch)
        if train_cfg.grad_compression == "int8_pod":
            grads = compressed_pod_allreduce(grads, mesh)
        elif pods:
            grads = _pod_mean(grads, mesh)
        if pods:
            loss, metrics = _pod_mean((loss, metrics), mesh)
        params, opt_state, opt_metrics = adamw.apply_updates(
            train_cfg.opt, params, grads, opt_state)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return params, opt_state, metrics

    return train_step
