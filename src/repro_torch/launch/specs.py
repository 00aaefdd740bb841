"""Abstract inputs + specs for every (arch × shape × mesh) cell (port of
the reference's ``launch/specs.py``, without its dry run's ``Lowerable``
and ``build_*`` step builders).

Everything here is allocation-free: parameters, optimizer state, batches
and KV caches materialise as ``meta``-device tensors, and the specs are
computed against any mesh that names its axes and sizes — an abstract
``MeshSpec`` (16×16, 2×16×16 in one process) or a ``DeviceMesh``.  The
same builders place the real training and serving trees
(``parallel.sharding.placements``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import BIG_ARCHS, ShapeSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import abstract_params, logical_tree
from repro_torch.models.transformer import model_defs
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (P, walk, fit_spec, is_spec,
                                           mesh_axes, spec_tree)
from repro_torch.serving.cache import cache_logical_tree, init_cache
from repro_torch.train.train_step import TrainConfig


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def batch_axes(mesh, n: int) -> Tuple[str, ...]:
    """Largest prefix of (pod, data) that evenly divides n."""
    sizes = mesh_axes(mesh)
    out = []
    size = 1
    for a in ("pod", "data"):
        if a in sizes and n % (size * sizes[a]) == 0:
            out.append(a)
            size *= sizes[a]
    return tuple(out)


def _lead(axes: Tuple[str, ...]):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def batch_spec(mesh, n: int, extra_dims: int = 1) -> P:
    lead = _lead(batch_axes(mesh, n))
    return P(lead, *([None] * extra_dims)) if extra_dims else P(lead)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


# ---------------------------------------------------------------------------
# parameters + optimizer
# ---------------------------------------------------------------------------

def param_pack(cfg: ModelConfig, mesh, dtype: torch.dtype = torch.bfloat16):
    defs = model_defs(cfg)
    abstract = abstract_params(defs, dtype)
    specs = spec_tree(logical_tree(defs), mesh)
    return defs, abstract, specs


def _moment_abstract(p: torch.Tensor, eightbit: bool):
    if not eightbit:
        return _meta(p.shape, torch.float32)
    nb = adamw.scale_blocks(p.shape[-1])
    return adamw.Moment8(_meta(p.shape, torch.int8),
                         _meta(tuple(p.shape[:-1]) + (nb,), torch.float32))


def _sanitize_spec(spec: P, shape, mesh) -> P:
    """Drop axes that no longer divide (scale tensors' shrunken last dim)."""
    return fit_spec(spec, shape, mesh)


def _moment_spec(param_spec: P, p: torch.Tensor, eightbit: bool, mesh):
    """int8 moments are parameter-shaped → they inherit the parameter's
    sharding verbatim; their block scales keep the axes that divide the
    scales' shrunken last dim."""
    if not eightbit:
        return param_spec
    nb = adamw.scale_blocks(p.shape[-1])
    return adamw.Moment8(
        param_spec,
        _sanitize_spec(param_spec, tuple(p.shape[:-1]) + (nb,), mesh))


def _zip_walk(fn, a, b):
    """``fn(a_leaf, b_leaf)`` over two trees of one structure, ``a``'s
    leaves specs."""
    leaves_b = iter(_leaves(b))
    return walk(a, lambda s: fn(s, next(leaves_b)), is_spec)


def opt_pack(abstract_p, param_specs, mesh, eightbit: bool):
    mu = walk(abstract_p, lambda p: _moment_abstract(p, eightbit),
               lambda x: isinstance(x, torch.Tensor))
    mu_s = _zip_walk(lambda s, p: _moment_spec(s, p, eightbit, mesh),
                     param_specs, abstract_p)
    state = adamw.AdamWState(step=_meta((), torch.int32), mu=mu, nu=mu)
    specs = adamw.AdamWState(step=P(), mu=mu_s, nu=mu_s)
    return state, specs


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------

def input_specs(cfg: ModelConfig, shape: ShapeSpec, mesh
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, P]]:
    """Training-batch meta tensors + specs for one shape."""
    b, s = shape.global_batch, shape.seq_len
    s_tok = s - cfg.frontend_prefix
    batch: Dict[str, Any] = {
        "tokens": _meta((b, s_tok), torch.int32),
        "labels": _meta((b, s_tok), torch.int32),
    }
    specs: Dict[str, P] = {
        "tokens": batch_spec(mesh, b, 1),
        "labels": batch_spec(mesh, b, 1),
    }
    if cfg.frontend_prefix:
        batch["prefix_embed"] = _meta((b, cfg.frontend_prefix, cfg.d_model),
                                      torch.bfloat16)
        specs["prefix_embed"] = batch_spec(mesh, b, 2)
    if cfg.encoder_layers:
        batch["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model),
                                torch.bfloat16)
        specs["frames"] = batch_spec(mesh, b, 2)
    return batch, specs


def default_train_config(arch_id: str, shape: ShapeSpec) -> TrainConfig:
    """4 microbatches from a global batch of 64, else 1; bf16 gradient
    accumulation and 8-bit moments for the ≥100B architectures."""
    big = arch_id in BIG_ARCHS
    micro = 4 if shape.global_batch >= 64 else 1
    return TrainConfig(
        microbatches=micro,
        grad_accum_dtype=torch.bfloat16 if big else torch.float32,
        opt=adamw.AdamWConfig(eightbit=big),
    )


# ---------------------------------------------------------------------------
# cache specs (decode / prefill)
# ---------------------------------------------------------------------------

def cache_pack(cfg: ModelConfig, mesh, batch: int, max_seq: int,
               dtype: torch.dtype = torch.bfloat16, *,
               seq_all: bool = False):
    """Abstract ``CacheTree`` + spec tree.

    ``seq_all`` (long-context, batch=1): dense-KV sequence shards over
    *both* (data, model)."""
    abstract = init_cache(cfg, batch, max_seq, dtype, device="meta")
    names = mesh_axes(mesh)

    def resolve(lg):
        spec = []
        for ax in lg:
            if ax == "batch":
                spec.append(_lead(batch_axes(mesh, batch)))
            elif ax == "seq":
                if seq_all:
                    spec.append(_lead(tuple(a for a in ("data", "model")
                                            if a in names)))
                else:
                    spec.append("model" if "model" in names else None)
            elif ax == "tp":
                spec.append("model" if "model" in names else None)
            else:
                spec.append(None)
        return P(*spec)

    logical = cache_logical_tree(cfg)
    specs = walk(logical, resolve, lambda x: isinstance(x, tuple) and all(
        a is None or isinstance(a, str) for a in x))
    # drop non-dividing axes (e.g. batch=1) leaf by leaf
    specs = _zip_walk(lambda s, leaf: fit_spec(s, leaf.shape, mesh), specs,
                      abstract)
    return abstract, specs


# ---------------------------------------------------------------------------
# per-device bytes
# ---------------------------------------------------------------------------

def _leaves(tree):
    out = []
    walk(tree, out.append, lambda x: isinstance(x, torch.Tensor))
    return out


def sharded_arg_bytes(abstract_tree, spec_tree_, mesh) -> int:
    """Exact per-device bytes of the (sharded) arguments."""
    sizes = mesh_axes(mesh)
    specs = []
    walk(spec_tree_, specs.append, is_spec)
    leaves = _leaves(abstract_tree)
    assert len(specs) == len(leaves), (len(specs), len(leaves))
    total = 0
    for leaf, spec in zip(leaves, specs):
        nbytes = int(np.prod(leaf.shape)) * leaf.element_size()
        div = 1
        for entry in tuple(spec):
            if entry is None:
                continue
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                div *= sizes[a]
        total += -(-nbytes // max(1, div))
    return total
