"""LM serving driver: batched prefill + decode with generational batching
(port of the reference's ``launch/serve.py``).

Requests queue up, get packed into fixed-size batches, prefilled, then
decoded step by step until every request of the batch has its tokens; the
next generation then takes the next requests.  Prompts of one batch are
left-padded with token 0 to the longest and not masked, as in the
reference.  Runs on the card unless ``device`` names another; with no card
and no device named, :class:`~repro_torch.device.NoDeviceError` is raised
before any work.

A generation's prompt length (its longest prompt) must be one the
reference's recurrent prefill takes: for RWKV-6 at most 64 or a multiple
of 64 (the WKV chunk), for Mamba at most 128 or a multiple of 128 (the
scan chunk); another raises ``ValueError``.  ``main``'s prompts are 4–11
tokens.

    python -m repro_torch.launch.serve --arch lm100m [--device cpu]
        [--dtype float32|bf16]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.params import init_params
from repro_torch.models.transformer import model_defs
from repro_torch.serving.cache import init_cache
from repro_torch.serving.engine import decode_step, prefill

DTYPES = {"float32": torch.float32, "bf16": torch.bfloat16}

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class Generation:
    """What one generation fed and got (``Server(record=True)``): the
    left-padded prompts (bs, plen), the tokens fed at each decode step
    with their position, the logits of the prefill and of each step
    (device tensors, (bs, vocab_padded)), and the host-clock seconds of
    the prefill and of each step, each ending in the read-back of its
    next tokens."""
    prompts: np.ndarray
    steps: List[tuple] = dataclasses.field(default_factory=list)
    logits: List[torch.Tensor] = dataclasses.field(default_factory=list)
    seconds: List[float] = dataclasses.field(default_factory=list)


class Server:
    """Fixed-batch generational server over the serving engine."""

    def __init__(self, cfg, params, *, batch_size: int = 4,
                 max_seq: int = 512, dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None, record: bool = False):
        self.device = resolve_device(device)
        held = params["embed"].device
        if held.type != self.device.type:
            raise ValueError(f"parameters are on {held}, the server on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.bs = batch_size
        self.max_seq = max_seq
        self.dtype = dtype
        self.queue: List[Request] = []
        self.record = record
        self.generations: List[Generation] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _fill_batch(self) -> List[Request]:
        batch = []
        while self.queue and len(batch) < self.bs:
            batch.append(self.queue.pop(0))
        return batch

    def run(self, *, max_steps: int = 1000) -> Dict[int, List[int]]:
        """Process the queue to completion: each generation packs up to
        ``bs`` requests, padding shorter prompts on the left.  The next
        tokens are read back once a step."""
        results: Dict[int, List[int]] = {}
        with torch.inference_mode():
            while self.queue:
                self._generation(self._fill_batch(), results, max_steps)
        return results

    def _generation(self, batch: List[Request], results, max_steps) -> None:
        n = len(batch)
        plen = max(len(r.prompt) for r in batch)
        toks = np.zeros((self.bs, plen), np.int32)
        for i, r in enumerate(batch):
            toks[i, plen - len(r.prompt):] = r.prompt     # left pad
        gen = Generation(toks) if self.record else None
        t0 = time.perf_counter()
        cache = init_cache(self.cfg, self.bs, self.max_seq, self.dtype,
                           self.device)
        logits, cache = prefill(self.params, self.cfg,
                                torch.from_numpy(toks).to(self.device), cache)
        nxt = torch.argmax(logits, -1).cpu().numpy()
        if gen is not None:
            gen.seconds.append(time.perf_counter() - t0)
            gen.logits.append(logits)
        for i, r in enumerate(batch):
            r.out_tokens.append(int(nxt[i]))
        pos = plen
        live = list(range(n))
        steps = 0
        while live and steps < max_steps:
            t0 = time.perf_counter()
            fed = torch.from_numpy(nxt.astype(np.int64)).to(self.device)
            logits, cache = decode_step(self.params, self.cfg, cache, fed,
                                        pos)
            if gen is not None:
                gen.steps.append((nxt, pos))
                gen.logits.append(logits)
            nxt = torch.argmax(logits, -1).cpu().numpy()
            if gen is not None:
                gen.seconds.append(time.perf_counter() - t0)
            pos += 1
            steps += 1
            for i in list(live):
                r = batch[i]
                r.out_tokens.append(int(nxt[i]))
                if len(r.out_tokens) >= r.max_new:
                    r.done = True
                    results[r.rid] = r.out_tokens
                    live.remove(i)
        for r in batch:
            if not r.done:
                results[r.rid] = r.out_tokens
        if gen is not None:
            self.generations.append(gen)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="lm100m")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="float32",
                    help="weights and KV cache (default float32)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    dtype = DTYPES[args.dtype]

    cfg = get_smoke(args.arch)
    params = init_params(model_defs(cfg), seed=0, dtype=dtype, device=device)
    server = Server(cfg, params, batch_size=4, max_seq=128, dtype=dtype,
                    device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    for rid in range(args.requests):
        plen = int(rng.integers(4, 12))
        server.submit(Request(
            rid, rng.integers(0, cfg.vocab, plen).astype(np.int32),
            args.max_new))
    results = server.run()
    dt = time.time() - t0
    total = sum(len(v) for v in results.values())
    print(f"served {len(results)} requests, {total} tokens "
          f"in {dt:.1f}s ({total / dt:.1f} tok/s) on {device}, "
          f"{args.arch} smoke, {args.dtype}")
    for rid in sorted(results):
        print(f"  req {rid}: {results[rid][:8]}...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
