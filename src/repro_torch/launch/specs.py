"""Abstract inputs + specs for every (arch × shape × mesh) cell, and the
dry run's step builders (port of the reference's ``launch/specs.py``).

Everything here is allocation-free: parameters, optimizer state, batches
and KV caches materialise as ``meta``-device tensors, and the specs are
computed against any mesh that names its axes and sizes — an abstract
``MeshSpec`` (16×16, 2×16×16 in one process) or a ``DeviceMesh``.  The
same builders place the real training and serving trees
(``parallel.sharding.placements``).

``build_train`` / ``build_prefill`` / ``build_decode`` / ``build_cell``
return a :class:`Lowerable`: the sharded step and its arguments, placed
on a ``DeviceMesh`` as DTensors.  Under the dry run's fake process group
(``launch.mesh.init_fake``) every local shard is an empty ``meta``
tensor; with ``device`` a real one, the arguments are the real
constructors' (``init_params``, ``adamw.init``, ``init_cache``) and a
seeded batch, so that the same step runs for real.
``Lowerable.lower()`` runs the step once under
``analysis.op_cost.OpCounter`` and returns its trace: nothing is
compiled.  The steps read nothing back to the host (a ``meta`` tensor
has no value): decode takes its position as a host int, the cache's last
slot.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import BIG_ARCHS, SHAPES, ShapeSpec, get_config
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (abstract_params, init_params,
                                       is_tensor, logical_tree, tensors)
from repro_torch.models.transformer import model_defs
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (P, walk, fit_spec, is_spec,
                                           local_shape, mesh_axes,
                                           placements, spec_tree)
from repro_torch.serving.cache import cache_logical_tree, init_cache
from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                         param_mesh)


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


# ---------------------------------------------------------------------------
# lowerable step builders
# ---------------------------------------------------------------------------

ShapeLike = Union[str, ShapeSpec]


def _shape(shape: ShapeLike) -> ShapeSpec:
    return SHAPES[shape] if isinstance(shape, str) else shape


def place(abstract_tree, spec_tree_, mesh, device: Any = "meta"):
    """``abstract_tree`` as DTensors on ``mesh`` with each spec's
    placements: empty local shards on ``meta``, zeros on a real
    ``device``."""
    from torch.distributed.tensor import DTensor
    it = iter(_leaves(abstract_tree))

    def make(spec):
        like = next(it)
        places = placements(fit_spec(spec, like.shape, mesh), mesh)
        shape = local_shape(like.shape, places, mesh)
        make_local = torch.empty if str(device) == "meta" else torch.zeros
        local = make_local(shape, dtype=like.dtype, device=device)
        return DTensor.from_local(local, mesh, places, run_check=False,
                                  shape=like.shape, stride=like.stride())

    return walk(spec_tree_, make, is_spec)


def _as_dtype(tree, dtype: torch.dtype):
    """The floating leaves of an abstract tree in ``dtype``."""
    return walk(tree, lambda t: _meta(t.shape, dtype)
                if t.is_floating_point() else t,
                lambda x: isinstance(x, torch.Tensor))


def _fill_inputs(tree, cfg: ModelConfig) -> None:
    """Seeded values in a placed batch's local shards: token ids below
    the vocabulary, floats ~ N(0, 1)."""
    for i, t in enumerate(_leaves(tree)):
        local = t.to_local()
        if str(local.device) == "meta":
            continue
        gen = torch.Generator(device=local.device)
        gen.manual_seed(i)
        if local.is_floating_point():
            local.copy_(torch.randn(local.shape, generator=gen,
                                    device=local.device))
        else:
            local.copy_(torch.randint(0, cfg.vocab, local.shape,
                                      generator=gen, device=local.device))


def _params(cfg: ModelConfig, mesh, dtype, device):
    """The parameters placed on ``mesh``: empty shards on ``meta``, else
    ``init_params``'s seeded draw."""
    defs, abs_p, p_specs = param_pack(cfg, mesh, dtype)
    if str(device) == "meta":
        return place(abs_p, p_specs, mesh, device)
    return init_params(defs, seed=0, dtype=dtype, device=device,
                       mesh=mesh)


def local_bytes(tree) -> int:
    """Bytes of the local shards (a DTensor's) or whole tensors of a tree;
    a host int (the decode's position) counts as the int32 scalar the
    reference passes."""
    ints = []
    walk(tree, ints.append, lambda x: isinstance(x, int)
         and not isinstance(x, bool))
    return 4 * len(ints) + sum(
        t.to_local().nbytes if hasattr(t, "to_local") else t.nbytes
        for t in _leaves(tree))


@dataclasses.dataclass
class Lowerable:
    """A sharded step and the placed arguments to trace it with."""
    fn: Callable
    args: Tuple[Any, ...]
    arg_bytes_per_device: Optional[int] = None

    def lower(self):
        """One run of the step under the op counter: its
        ``op_cost.Trace``."""
        from repro_torch.analysis import op_cost
        _, tr = op_cost.trace(self.fn, *self.args)
        return tr

    def local_arg_bytes(self) -> int:
        """The local bytes of the placed arguments (every rank holds its
        shards; a host int holds none)."""
        return local_bytes(self.args)


def build_train(arch_id: str, shape_name: ShapeLike, mesh,
                cfg: Optional[ModelConfig] = None,
                train_cfg: Optional[TrainConfig] = None, *,
                dtype: torch.dtype = torch.bfloat16, device: Any = "meta") -> Lowerable:
    """The sharded train step (``train_step.make_train_step`` on
    ``mesh``).  With a ``pod`` axis the parameters, moments and each
    pod's rows of the batch live on the in-pod mesh, as ``launch.train``
    places them; the argument bytes are the reference's, from the specs
    on the whole mesh."""
    cfg = cfg or get_config(arch_id)
    shape = _shape(shape_name)
    train_cfg = train_cfg or default_train_config(arch_id, shape)
    eightbit = train_cfg.opt.eightbit
    pmesh = param_mesh(mesh)
    params = _params(cfg, pmesh, dtype, device)
    for p in tensors(params):
        p.requires_grad_(True)
    if str(device) == "meta":
        _, abs_pp, pp_specs = param_pack(cfg, pmesh, dtype)
        abs_po, po_specs = opt_pack(abs_pp, pp_specs, pmesh, eightbit)
        opt = place(abs_po._replace(step=None), po_specs._replace(step=None),
                    pmesh, device)._replace(step=_meta((), torch.int32))
    else:
        opt = adamw.init(train_cfg.opt, params)
    pods = mesh_axes(mesh).get("pod", 1)
    if shape.global_batch % pods:
        raise ValueError(f"a global batch of {shape.global_batch} does not "
                         f"split over {pods} pods")
    pod_shape = dataclasses.replace(shape,
                                    global_batch=shape.global_batch // pods)
    pod_batch, pod_specs = input_specs(cfg, pod_shape, pmesh)
    batch = place(_as_dtype(pod_batch, dtype), pod_specs, pmesh, device)
    _fill_inputs(batch, cfg)
    _, abs_p, p_specs = param_pack(cfg, mesh, dtype)
    abs_opt, opt_specs = opt_pack(abs_p, p_specs, mesh, eightbit)
    abs_batch, b_specs = input_specs(cfg, shape, mesh)
    ab = sharded_arg_bytes((abs_p, abs_opt, _as_dtype(abs_batch, dtype)),
                           (p_specs, opt_specs, b_specs), mesh)
    step = make_train_step(cfg, train_cfg, mesh)
    return Lowerable(step, (params, opt, batch), ab)


def _cache(cfg: ModelConfig, mesh, b: int, s: int, dtype, device,
           seq_all: bool):
    abs_cache, c_specs = cache_pack(cfg, mesh, b, s, dtype, seq_all=seq_all)
    if str(device) == "meta":
        cache = place(abs_cache, c_specs, mesh, device)
    else:
        cache = init_cache(cfg, b, s, dtype, device, mesh=mesh,
                           seq_all=seq_all)
    return cache, abs_cache, c_specs


def _modal(cfg: ModelConfig, mesh, b: int, dtype):
    """(abstract, specs) of the prefill's modality inputs."""
    abs_kw: Dict[str, Any] = {}
    specs: Dict[str, P] = {}
    if cfg.frontend_prefix:
        abs_kw["prefix_embed"] = _meta((b, cfg.frontend_prefix,
                                        cfg.d_model), dtype)
        specs["prefix_embed"] = batch_spec(mesh, b, 2)
    if cfg.encoder_layers:
        abs_kw["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), dtype)
        specs["frames"] = batch_spec(mesh, b, 2)
    return abs_kw, specs


def build_prefill(arch_id: str, shape_name: ShapeLike, mesh,
                  cfg: Optional[ModelConfig] = None, *,
                  dtype: torch.dtype = torch.bfloat16, device: Any = "meta") -> Lowerable:
    """The sharded prefill (``serving.engine.prefill``) of the whole
    prompt into a cache of its length; ``seq_all`` when the batch is 1."""
    from repro_torch.serving.engine import prefill
    cfg = cfg or get_config(arch_id)
    shape = _shape(shape_name)
    b, s = shape.global_batch, shape.seq_len
    s_tok = s - cfg.frontend_prefix
    cache, abs_cache, c_specs = _cache(cfg, mesh, b, s, dtype, device,
                                       b == 1)
    params = _params(cfg, mesh, dtype, device)
    _, abs_p, p_specs = param_pack(cfg, mesh, dtype)
    tokens_abs = _meta((b, s_tok), torch.int32)
    t_spec = batch_spec(mesh, b, 1)
    kw_abs, kw_specs = _modal(cfg, mesh, b, dtype)
    tokens = place(tokens_abs, t_spec, mesh, device)
    kw = place(kw_abs, kw_specs, mesh, device)
    _fill_inputs((tokens, kw), cfg)

    @torch.no_grad()
    def step(params, tokens, cache, kw):
        return prefill(params, cfg, tokens, cache, **kw)

    ab = sharded_arg_bytes((abs_p, tokens_abs, abs_cache, kw_abs),
                           (p_specs, t_spec, c_specs, kw_specs), mesh)
    return Lowerable(step, (params, tokens, cache, kw), ab)


def build_decode(arch_id: str, shape_name: ShapeLike, mesh,
                 cfg: Optional[ModelConfig] = None, *,
                 dtype: torch.dtype = torch.bfloat16, device: Any = "meta") -> Lowerable:
    """One sharded decode step (``serving.engine.decode_step``) over a
    cache of the shape's length, at its last slot; the enc-dec decode
    attends over an encoder output."""
    from repro_torch.serving.engine import decode_step
    cfg = cfg or get_config(arch_id)
    shape = _shape(shape_name)
    b, s = shape.global_batch, shape.seq_len
    pos = s - 1
    cache, abs_cache, c_specs = _cache(cfg, mesh, b, s, dtype, device,
                                       b == 1)
    params = _params(cfg, mesh, dtype, device)
    _, abs_p, p_specs = param_pack(cfg, mesh, dtype)
    tokens_abs = _meta((b,), torch.int32)
    t_spec = batch_spec(mesh, b, 0)
    tokens = place(tokens_abs, t_spec, mesh, device)
    abs_args = [abs_p, abs_cache, tokens_abs, _meta((), torch.int32)]
    arg_specs = [p_specs, c_specs, t_spec, P()]
    enc = None
    if cfg.encoder_layers:
        enc_abs = _meta((b, cfg.encoder_seq, cfg.d_model), dtype)
        enc_spec = batch_spec(mesh, b, 2)
        enc = place(enc_abs, enc_spec, mesh, device)
        abs_args.append(enc_abs)
        arg_specs.append(enc_spec)
    _fill_inputs((tokens, enc), cfg)

    @torch.no_grad()
    def step(params, cache, tokens, pos, enc_out):
        return decode_step(params, cfg, cache, tokens, pos, enc_out=enc_out)

    ab = sharded_arg_bytes(tuple(abs_args), tuple(arg_specs), mesh)
    return Lowerable(step, (params, cache, tokens, pos, enc), ab)


def build_cell(arch_id: str, shape_name: ShapeLike, mesh, **kw
               ) -> Lowerable:
    kind = _shape(shape_name).kind
    if kind == "train":
        return build_train(arch_id, shape_name, mesh, **kw)
    if kind == "prefill":
        return build_prefill(arch_id, shape_name, mesh, **kw)
    return build_decode(arch_id, shape_name, mesh, **kw)
