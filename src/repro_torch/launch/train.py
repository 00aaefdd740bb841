"""Training driver: config-driven, fault-tolerant, checkpointed (port of
the reference's ``launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch lm100m \\
        --steps 300 --global-batch 32 --seq-len 256 --ckpt-dir build/ckpt

Runs on the CUDA card unless ``--device`` names another.  One device has
no mesh: the reference's ``--mesh`` and the parameter and optimizer
shardings are left out, and a checkpoint restores onto the device.
Parameters are drawn with the port's ``init_params`` in float32, and the
loop runs inside ``strict_float32()`` (TF32 off).
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
from repro_torch.configs import BIG_ARCHS, get_config, get_smoke
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.device import DeviceLike, resolve_device, strict_float32
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params, tensors
from repro_torch.models.transformer import model_defs
from repro_torch.optim import adamw
from repro_torch.runtime.fault_tolerance import (FailureInjector, LoopReport,
                                                 resilient_train_loop)
from repro_torch.train.train_step import TrainConfig, make_train_step


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    metrics: Dict[str, float]


def default_train_config(arch_id: str, global_batch: int,
                         steps: int) -> TrainConfig:
    """The reference's rule (``launch/specs.default_train_config``): 4
    microbatches from a global batch of 64, else 1; bf16 gradient
    accumulation and 8-bit moments for the ≥100B architectures
    (``BIG_ARCHS``); the driver's schedule, warmup a twentieth of
    ``steps``."""
    big = arch_id in BIG_ARCHS
    return TrainConfig(
        microbatches=4 if global_batch >= 64 else 1,
        grad_accum_dtype=torch.bfloat16 if big else torch.float32,
        opt=adamw.AdamWConfig(eightbit=big, total_steps=steps,
                              warmup_steps=max(1, steps // 20)))


def _require_grad(params):
    for p in tensors(params):
        p.requires_grad_(True)
    return params


def build_trainer(cfg: ModelConfig, train_cfg: TrainConfig,
                  data_cfg: DataConfig, seed: int = 0,
                  device: DeviceLike = None
                  ) -> Tuple[Callable[[], TrainState],
                             Callable[[TrainState, int], TrainState]]:
    """Returns (init_state, run_step) for the driver.  ``run_step`` reads
    the step's metrics back to the host once, as floats."""
    device = resolve_device(device)
    defs = model_defs(cfg)
    step_fn = make_train_step(cfg, train_cfg)

    def init_state() -> TrainState:
        params = _require_grad(init_params(defs, seed=seed,
                                           dtype=torch.float32,
                                           device=device))
        return TrainState(params, adamw.init(train_cfg.opt, params), {})

    def run_step(state: TrainState, step: int) -> TrainState:
        batch = make_batch(data_cfg, step, device)
        params, opt, metrics = step_fn(state.params, state.opt_state, batch)
        names = sorted(metrics)
        values = torch.stack([metrics[k].float() for k in names]).tolist()
        return TrainState(params, opt, dict(zip(names, values)))

    return init_state, run_step


def train(cfg: ModelConfig, *, steps: int, global_batch: int, seq_len: int,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          train_cfg: Optional[TrainConfig] = None,
          fail_at: Optional[List[int]] = None, seed: int = 0,
          log_every: int = 10, watchdog_s: Optional[float] = None,
          device: DeviceLike = None,
          step_hook: Optional[Callable[[TrainState, int], None]] = None
          ) -> LoopReport:
    """Train ``cfg`` for ``steps`` steps of ``global_batch`` sequences of
    ``seq_len`` tokens from the seeded synthetic stream, checkpointing
    every ``ckpt_every`` steps to ``ckpt_dir`` (a temporary directory,
    removed after, when None) and restarting from the last checkpoint at
    each step of ``fail_at``.  ``train_cfg`` defaults to
    :func:`default_train_config` of ``cfg.name``.  ``step_hook(state,
    step)``, when given, runs after every step that completes."""
    device = resolve_device(device)
    train_cfg = train_cfg or default_train_config(cfg.name, global_batch,
                                                  steps)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=seq_len,
                          global_batch=global_batch, seed=seed,
                          frontend_prefix=cfg.frontend_prefix,
                          d_model=cfg.d_model,
                          encoder_seq=(cfg.encoder_seq
                                       if cfg.encoder_layers else 0))
    init_state, run_step = build_trainer(cfg, train_cfg, data_cfg, seed,
                                         device)

    def step_wrap(state: TrainState, step: int) -> TrainState:
        state = run_step(state, step)
        if step_hook is not None:
            step_hook(state, step)
        if log_every and step % log_every == 0:
            m = state.metrics
            print(f"step {step:5d} loss={m.get('loss', float('nan')):.4f} "
                  f"acc={m.get('accuracy', 0):.3f} "
                  f"gnorm={m.get('grad_norm', 0):.2f}", flush=True)
        return state

    def save_tree(state: TrainState):
        return {"params": state.params, "opt": state.opt_state}

    def restore(ckptr: Checkpointer, step: int, state: TrainState):
        tree = ckptr.restore(step, save_tree(state), device)
        return TrainState(_require_grad(tree["params"]), tree["opt"], {})

    with contextlib.ExitStack() as stack:
        if ckpt_dir is None:
            ckpt_dir = stack.enter_context(tempfile.TemporaryDirectory())
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
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    t0 = time.time()
    report = train(cfg, steps=args.steps, global_batch=args.global_batch,
                   seq_len=args.seq_len, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, device=device)
    dt = time.time() - t0
    last = report.metrics_history[-1] if report.metrics_history else {}
    print(f"done: {report.final_step} steps in {dt:.1f}s, "
          f"final loss={last.get('loss')}, restarts={report.restarts} "
          f"on {device}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
