"""Training driver: config-driven, fault-tolerant, checkpointed (port of
the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch lm100m \\
        --steps 300 --global-batch 32 --seq-len 256 --ckpt-dir build/ckpt

Runs on the CUDA card unless ``--device`` names another.  ``--mesh
smoke|pod|multipod`` (the reference's 1×1, 16×16 and 2×16×16) or
``--mesh-shape DxM`` / ``PxDxM`` (``2x2``, ``2x1x2``: the small meshes
tests and one card hold) trains on a ``DeviceMesh`` of one process a
device — started by ``torchrun`` (one process a card, over ``nccl``;
``gloo`` with ``--device cpu``):

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch lm100m --smoke --mesh-shape 2x2 --device cpu

A mesh whose size is not the number of processes raises.  On a mesh the
parameters and moments are DTensors placed by ``launch.specs``'s specs,
the batch each rank's own rows, and a checkpoint (written by rank 0,
full tensors) restores onto whatever mesh runs the restart.  Without a
mesh the loop runs on the one device, as before.  Parameters are drawn
with the port's ``init_params`` in float32, and the loop runs inside
``strict_float32()`` (TF32 off).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.checkpoint.checkpointer import Checkpointer
from repro_torch.configs import ShapeSpec, get_config, get_smoke
from repro_torch.data.pipeline import (DataConfig, make_batch,
                                       make_global_batch)
from repro_torch.device import DeviceLike, resolve_device, strict_float32
from repro_torch.launch import specs
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params, tensors
from repro_torch.models.transformer import model_defs
from repro_torch.optim import adamw
from repro_torch.parallel.sharding import (NamedSharding, is_spec,
                                           placements, walk)
from repro_torch.runtime.fault_tolerance import (FailureInjector, LoopReport,
                                                 resilient_train_loop)
from repro_torch.train.train_step import (TrainConfig, make_train_step,
                                         param_mesh)


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    metrics: Dict[str, float]


def default_train_config(arch_id: str, global_batch: int,
                         steps: int) -> TrainConfig:
    """``launch.specs.default_train_config``'s rule (4 microbatches from
    a global batch of 64, bf16 gradient accumulation and 8-bit moments
    for the ≥100B architectures) with the driver's schedule: warmup a
    twentieth of ``steps``."""
    tc = specs.default_train_config(
        arch_id, ShapeSpec("driver", 0, global_batch, "train"))
    return dataclasses.replace(tc, opt=dataclasses.replace(
        tc.opt, total_steps=steps, warmup_steps=max(1, steps // 20)))


def _require_grad(params):
    for p in tensors(params):
        p.requires_grad_(True)
    return params


def _shardings(spec_tree, mesh):
    return walk(spec_tree, lambda sp: NamedSharding(
        mesh, placements(sp, mesh)), is_spec)


def build_trainer(cfg: ModelConfig, train_cfg: TrainConfig,
                  data_cfg: DataConfig, seed: int = 0,
                  device: DeviceLike = None, mesh=None
                  ) -> Tuple[Callable[[], TrainState],
                             Callable[[TrainState, int], TrainState], Any]:
    """Returns (init_state, run_step, shardings) for the driver.
    ``run_step`` reads the step's metrics back to the host once, as
    floats.  ``shardings`` is ``{"params": ..., "opt": ...}``, trees of
    ``NamedSharding`` on the in-pod mesh (None without a mesh)."""
    device = resolve_device(device)
    pmesh = param_mesh(mesh)
    defs = model_defs(cfg)
    shardings = None
    if mesh is not None:
        _, abs_p, p_specs = specs.param_pack(cfg, pmesh, torch.float32)
        _, o_specs = specs.opt_pack(abs_p, p_specs, pmesh,
                                    train_cfg.opt.eightbit)
        # the step counter is a plain tensor on every rank
        shardings = {"params": _shardings(p_specs, pmesh),
                     "opt": _shardings(o_specs._replace(step=None), pmesh)}
    step_fn = make_train_step(cfg, train_cfg, mesh)

    def init_state() -> TrainState:
        params = _require_grad(init_params(defs, seed=seed,
                                           dtype=torch.float32,
                                           device=device, mesh=pmesh))
        return TrainState(params, adamw.init(train_cfg.opt, params), {})

    def run_step(state: TrainState, step: int) -> TrainState:
        batch = (make_batch(data_cfg, step, device) if mesh is None
                 else make_global_batch(data_cfg, step, mesh))
        params, opt, metrics = step_fn(state.params, state.opt_state, batch)
        names = sorted(metrics)
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        return TrainState(params, opt, dict(zip(names, values)))

    return init_state, run_step, shardings


def _shared(stack: contextlib.ExitStack, mesh) -> str:
    """A temporary checkpoint directory, removed at the end: rank 0's,
    its name sent to every rank of a mesh (one host's ranks)."""
    import torch.distributed as dist
    if mesh is None or dist.get_world_size() == 1:
        return stack.enter_context(tempfile.TemporaryDirectory())
    name = [stack.enter_context(tempfile.TemporaryDirectory())
            if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(name, src=0)
    return name[0]


def train(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          train_cfg: Optional[TrainConfig] = None,
          fail_at: Optional[List[int]] = None, seed: int = 0,
          log_every: int = 10, watchdog_s: Optional[float] = None,
          device: DeviceLike = None, mesh=None,
          step_hook: Optional[Callable[[TrainState, int], None]] = None
          ) -> LoopReport:
    """Train ``cfg`` for ``steps`` steps of ``global_batch`` sequences of
    ``seq_len`` tokens from the seeded synthetic stream, checkpointing
    every ``ckpt_every`` steps to ``ckpt_dir`` (a temporary directory,
    removed after, when None) and restarting from the last checkpoint at
    each step of ``fail_at``.  ``train_cfg`` defaults to
    :func:`default_train_config` of ``cfg.name``.  ``step_hook(state,
    step)``, when given, runs after every step that completes.  ``mesh``:
    a ``DeviceMesh`` (``launch.mesh``) to train on, every rank calling
    this alike; the checkpoint directory is then shared by the ranks."""
    device = resolve_device(device)
    train_cfg = train_cfg or default_train_config(cfg.name, global_batch,
                                                  steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch, seed=seed,
                          frontend_prefix=cfg.frontend_prefix,
                          d_model=cfg.d_model,
                          encoder_seq=(cfg.encoder_seq
                                       if cfg.encoder_layers else 0))
    init_state, run_step, shardings = build_trainer(
        cfg, train_cfg, data_cfg, seed, device, mesh)

    loud = mesh is None or mesh.get_rank() == 0

    def step_wrap(state: TrainState, step: int) -> TrainState:
        state = run_step(state, step)
        if step_hook is not None:
            step_hook(state, step)
        if log_every and step % log_every == 0 and loud:
            m = state.metrics
            print(f"step {step:5d} loss={m.get('loss', float('nan')):.4f} "
                  f"acc={m.get('accuracy', 0):.3f} "
                  f"gnorm={m.get('grad_norm', 0):.2f}", flush=True)
        return state

    def save_tree(state: TrainState):
        return {"params": state.params, "opt": state.opt_state}

    def restore(ckptr: Checkpointer, step: int, state: TrainState):
        tree = ckptr.restore(step, save_tree(state),
                             {"params": shardings["params"],
                              "opt": shardings["opt"]}
                             if shardings else None, device=device)
        return TrainState(_require_grad(tree["params"]), tree["opt"], {})

    with contextlib.ExitStack() as stack:
        if ckpt_dir is None:
            ckpt_dir = _shared(stack, mesh)
        stack.enter_context(strict_float32())
        return resilient_train_loop(
            state=init_state(), step_fn=step_wrap, save_tree_fn=save_tree,
            restore_fn=restore, checkpointer=Checkpointer(ckpt_dir, keep=3),
            total_steps=steps, ckpt_every=ckpt_every,
            watchdog_deadline_s=watchdog_s,
            failure_injector=FailureInjector(fail_at or []),
            metrics_fn=lambda s: s.metrics)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory (default: a temporary one)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--mesh", choices=["smoke", "pod", "multipod"],
                    default=None, help="train on the reference's mesh: "
                    "1x1, 16x16 or 2x16x16 processes")
    ap.add_argument("--mesh-shape", default=None,
                    help="train on a DxM (data, model) or PxDxM (pod, "
                    "data, model) mesh, e.g. 2x2")
    ap.add_argument("--fail-at", type=int, action="append", default=[],
                    help="raise at this step once (restart from the last "
                    "checkpoint)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    mesh = None
    if args.mesh or args.mesh_shape:
        from repro_torch.launch import mesh as meshes
        device = meshes.init_distributed(device)
        mesh = (meshes.mesh_from_shape(args.mesh_shape) if args.mesh_shape
                else {"smoke": meshes.make_smoke_mesh,
                      "pod": meshes.make_production_mesh,
                      "multipod": lambda: meshes.make_production_mesh(
                          multi_pod=True)}[args.mesh]())
    t0 = time.time()
    report = train(cfg, steps=args.steps, global_batch=args.global_batch,
                   seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, device=device, mesh=mesh,
                   fail_at=args.fail_at)
    dt = time.time() - t0
    last = report.metrics_history[-1] if report.metrics_history else {}
    where = device if mesh is None else f"{device}, mesh {mesh}"
    if mesh is None or mesh.get_rank() == 0:
        print(f"done: {report.final_step} steps in {dt:.1f}s, "
              f"final loss={last.get('loss')}, "
              f"restarts={report.restarts} on {where}")
    if mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
