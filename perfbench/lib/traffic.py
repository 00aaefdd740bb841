"""The one traffic generator: it reads a mix's parameters
(``traffic/<mix>.json``) and the configuration's input (``input``: shape
and the range of the int8 values) and draws the images from the seed.

``offline`` (MLPerf Inference's Offline scenario): the whole sample set is
there at once, so one caller issues ``serve`` calls of
``images_per_call`` images back to back, taking the batches of a pool of
``pool_batches`` in turn.

``server`` (MLPerf Inference's Server scenario): single-image requests
arrive open loop, Poisson at ``rate_per_s``, each taking image ``index mod
pool_images`` of a pool of request images.  The arrivals are drawn and
sent by a process of their own (:class:`Generator`, which runs this module
as ``python3 -m perfbench.lib.traffic``): it sends each ``(index, due
time)`` at its due time on ``time.perf_counter`` (``CLOCK_MONOTONIC``,
which every process of the machine shares), so the process that serves
can neither delay nor hurry the schedule.  The mix also gives the
serving engine's ``BatchPolicy`` (``policy``), its ``workers`` and the
untimed ``warmup_s`` before the window.

The images are uniform int8 over ``[low, high)``, as the port's seeded
request generators draw them (``serving/vta/loadgen.request_images``,
``lenet5_e2e.request_images``), drawn in one call a batch.
"""

from __future__ import annotations

import os
import pathlib
import struct
import subprocess
import sys
import time
from typing import Iterator, List, Optional

import numpy as np

from . import seeds

KINDS = ("offline", "server")
ROOT = pathlib.Path(__file__).resolve().parents[2]
# the arrivals are drawn in chunks of a fixed size, so a longer schedule of
# one seed begins with the shorter one
CHUNK = 1 << 16
COUNT = struct.Struct("<q")             # the generator's "ready": arrivals
START = struct.Struct("<d")             # the serving process's "go": t0
RECORD = 3                              # float64s a message: index, due, sent


def images(config: dict, n: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` images ``(n,) + input shape``, int8, uniform over the
    configuration's ``[low, high)``."""
    spec = config["input"]
    return rng.integers(spec["low"], spec["high"],
                        (n,) + tuple(spec["shape"]), dtype=np.int8)


def calibration_images(config: dict, seed: int) -> np.ndarray:
    """The configuration's calibration images and, last, the compile-time
    input: ``calibration.images + 1`` images."""
    n = config["calibration"]["images"] + 1
    return images(config, n, seeds.rng(seed, seeds.CALIBRATION))


def pool(config: dict, mix: dict, seed: int,
         images_per_call: Optional[int] = None) -> List[np.ndarray]:
    """The batches the cell's calls take in turn; for ``server``, one batch:
    the ``pool_images`` request images.  ``images_per_call`` overrides an
    offline mix's (the CPU tests run the harness small)."""
    if mix["kind"] not in KINDS:
        raise ValueError(f"traffic kind {mix['kind']!r} is not one of "
                         f"{KINDS}")
    rng = seeds.rng(seed, seeds.TRAFFIC)
    if mix["kind"] == "server":
        return [images(config, mix["pool_images"], rng)]
    b = images_per_call or mix["images_per_call"]
    return [images(config, b, rng) for _ in range(mix["pool_batches"])]


def arrivals(rate_per_s: float, seed: int, seconds: float) -> np.ndarray:
    """Due times, in seconds from the start, of a Poisson process at
    ``rate_per_s`` over ``[0, seconds)``: the sums of seeded exponential
    gaps."""
    rng = seeds.rng(seed, seeds.TRAFFIC, 1)
    parts, end = [], 0.0
    while end < seconds:
        t = end + np.cumsum(rng.exponential(1.0 / rate_per_s, CHUNK))
        parts.append(t)
        end = float(t[-1])
    t = np.concatenate(parts)
    return t[t < seconds]


def _read_exactly(fd: int, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = os.read(fd, n - len(out))
        if not chunk:
            return out
        out += chunk
    return out


def _write_all(fd: int, data: bytes) -> None:
    view = memoryview(data)
    while view:
        view = view[os.write(fd, view):]


def send(rate_per_s: float, seed: int, seconds: float) -> None:
    """The generator process's work: draw the arrivals, write their count
    to standard output, read the start ``t0`` (``time.perf_counter``) from
    standard input, then at each due time write ``(index, due, sent)`` of
    every arrival due by then, as float64s, and return after the last.  It
    sleeps between due times: spinning instead took a core from the
    process that serves and slowed its batches.  ``sent`` is the clock
    just before the write, so ``sent - due`` is how late the generator
    ran."""
    due = arrivals(rate_per_s, seed, seconds)
    _write_all(1, COUNT.pack(len(due)))
    start = _read_exactly(0, START.size)
    if len(start) < START.size:          # the serving process gave up
        return
    due = due + START.unpack(start)[0]
    i, n = 0, len(due)
    while i < n:
        now = time.perf_counter()
        if due[i] > now:
            time.sleep(due[i] - now)
            now = time.perf_counter()
        j = max(i + 1, int(np.searchsorted(due, now, side="right")))
        block = np.empty((j - i, RECORD))
        block[:, 0] = np.arange(i, j)
        block[:, 1] = due[i:j]
        block[:, 2] = now
        _write_all(1, block.tobytes())
        i = j


class Generator:
    """The arrivals' own process (:func:`send`), started at construction.

    ``ready()`` waits until it has drawn the schedule and returns the
    number of arrivals; ``go(t0)`` starts it; ``messages()`` yields the
    ``[index, due, sent]`` rows as they arrive, until the last; ``close()``
    ends the process (killing it only if it has not ended) and waits."""

    def __init__(self, rate_per_s: float, seed: int, seconds: float):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "perfbench.lib.traffic",
             repr(float(rate_per_s)), str(int(seed)), repr(float(seconds))],
            cwd=ROOT, stdin=subprocess.PIPE, stdout=subprocess.PIPE)

    def ready(self) -> int:
        head = _read_exactly(self.proc.stdout.fileno(), COUNT.size)
        if len(head) < COUNT.size:
            raise RuntimeError(f"the arrivals' process ended before it was "
                               f"ready (exit {self.proc.wait()})")
        return COUNT.unpack(head)[0]

    def go(self, t0: float) -> None:
        self.proc.stdin.write(START.pack(t0))
        self.proc.stdin.close()

    def messages(self) -> Iterator[list]:
        fd, size, rest = self.proc.stdout.fileno(), 8 * RECORD, b""
        while True:
            chunk = os.read(fd, 1 << 16)
            if not chunk:
                return
            rest += chunk
            whole = len(rest) - len(rest) % size
            if whole:
                rows = np.frombuffer(rest[:whole], "<f8").reshape(-1, RECORD)
                rest = rest[whole:]
                yield rows.tolist()

    def close(self) -> None:
        if self.proc.poll() is None and not self.proc.stdin.closed:
            self.proc.stdin.close()       # never started: it returns at once
        try:
            self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.proc.stdout.close()


def _main(argv: List[str]) -> int:
    rate, seed, seconds = float(argv[0]), int(argv[1]), float(argv[2])
    send(rate, seed, seconds)
    return 0


if __name__ == "__main__":
    sys.exit(_main(sys.argv[1:]))
