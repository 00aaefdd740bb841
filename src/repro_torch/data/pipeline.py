"""Deterministic synthetic data pipeline (port of the reference's
``data/pipeline.py``; ``DataConfig``, ``synth_sequence`` and
``host_batch`` are its numpy, copied).

Sequences are generated from a seeded per-(step, sequence) hash so any
part of the global batch is reproducible independently — exactly what a
restart-after-failure needs: the pipeline is stateless, resuming at step N
regenerates the same batches a failed run saw.

The token stream is an order-2 Markov chain over the vocab (so models can
actually learn structure), with labels = next token.  On one device
:func:`make_batch` puts ``host_batch``'s arrays on the device as they
are.  On a mesh :func:`make_global_batch` builds, as the reference's
per-shard callbacks do, only the rows of this rank's ``(pod, data)``
coordinate, as a DTensor sharded over the batch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_prefix: int = 0       # VLM/audio: embeddings prefix length
    d_model: int = 0               # for prefix embeddings
    encoder_seq: int = 0           # whisper frames


def _seq_rng(cfg: DataConfig, step: int, index: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, index]))


def synth_sequence(cfg: DataConfig, step: int, index: int) -> np.ndarray:
    """Order-2 Markov chain tokens (seq_len + 1,)."""
    rng = _seq_rng(cfg, step, index)
    v = cfg.vocab
    out = np.empty(cfg.seq_len + 1, np.int32)
    out[0] = rng.integers(v)
    out[1] = rng.integers(v)
    # two cheap hash-mixed transitions make the stream learnable
    a = int(rng.integers(1, v))
    b = int(rng.integers(1, v))
    noise = rng.random(cfg.seq_len + 1)
    for t in range(2, cfg.seq_len + 1):
        if noise[t] < 0.1:
            out[t] = rng.integers(v)
        else:
            out[t] = (a * out[t - 1] + b * out[t - 2] + 7) % v
    return out


def host_batch(cfg: DataConfig, step: int, lo: int, hi: int
               ) -> Dict[str, np.ndarray]:
    """Sequences [lo, hi) of the global batch for this step."""
    seqs = np.stack([synth_sequence(cfg, step, i) for i in range(lo, hi)])
    batch = {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
    if cfg.frontend_prefix and cfg.d_model:
        rng = _seq_rng(cfg, step, -1)
        batch["prefix_embed"] = rng.normal(
            0, 0.02, (hi - lo, cfg.frontend_prefix, cfg.d_model)
        ).astype(np.float32)
    if cfg.encoder_seq and cfg.d_model:
        rng = _seq_rng(cfg, step, -2)
        batch["frames"] = rng.normal(
            0, 0.02, (hi - lo, cfg.encoder_seq, cfg.d_model)
        ).astype(np.float32)
    return batch


def make_batch(cfg: DataConfig, step: int, device: DeviceLike = None
               ) -> Dict[str, torch.Tensor]:
    """The global batch of ``step`` (``host_batch`` over every sequence)
    as tensors on ``device`` (the card unless named): tokens and labels
    int32, prefix embeddings and frames float32."""
    device = resolve_device(device)
    return {name: torch.from_numpy(arr).to(device)
            for name, arr in host_batch(cfg, step, 0,
                                        cfg.global_batch).items()}


def batch_rows(cfg: DataConfig, mesh) -> tuple:
    """``[lo, hi)`` of the global batch that this rank's ``(pod, data)``
    coordinate holds (pod major)."""
    names = mesh.mesh_dim_names
    index, count = 0, 1
    for axis in ("pod", "data"):
        if axis in names:
            size = mesh.size(names.index(axis))
            index = index * size + mesh.get_local_rank(axis)
            count *= size
    if cfg.global_batch % count:
        raise ValueError(f"a global batch of {cfg.global_batch} does not "
                         f"split over {count} (pod, data) shards")
    rows = cfg.global_batch // count
    return index * rows, (index + 1) * rows


def make_global_batch(cfg: DataConfig, step: int, mesh
                      ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the batch of ``step`` (:func:`batch_rows`), as
    DTensors ``Shard(0)`` over ``data`` on the in-pod mesh (``mesh``
    without its ``pod`` axis): a pod's replica sees its own rows as its
    batch.  Tokens and labels int32, prefix embeddings and frames
    float32, on the mesh's device."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    names = mesh.mesh_dim_names
    sub = mesh[tuple(a for a in names if a != "pod")] if "pod" in names \
        else mesh
    lo, hi = batch_rows(cfg, mesh)
    places = [Shard(0) if a == "data" else Replicate()
              for a in sub.mesh_dim_names]
    device = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    out = {}
    for name, arr in host_batch(cfg, step, lo, hi).items():
        out[name] = DTensor.from_local(torch.from_numpy(arr).to(device),
                                       sub, places)
    return out
