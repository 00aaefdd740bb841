"""Seven per-layer numbers read off the port's own spans over the traced
``serve`` calls of a benchmark record.

The port records a span (``repro_torch.tracing``) for each stage of a
``serve`` call while a profiler records, each with its host start and
end, its device time (a CUDA event pair) and the ``bytes`` it wrote.  Each
reader takes a record as ``perfbench/run.py`` builds it (``rec["trace"]``
from ``perfbench.lib.trace``) and reads ``tracing.snapshot()``.  It reads
only where the span log holds exactly the traced calls' root spans and the
traced record holds device operations; otherwise, as on a port without
the spans, it returns None.

``tools/span_report.py`` prints them for a cell; ``READERS`` maps each
name to its reader.
"""

from __future__ import annotations

from typing import Iterable, List, Optional

ROOT = "repro_torch.serve"
INPUT = "repro_torch.serve.input"
OUTPUT = "repro_torch.serve.output"
STACK = "repro_torch.serve.stack"
STAGE = "repro_torch.layer.stage"
# INP decoded into the kernel's operand: only on a tree from before the
# operand was gathered straight from the producer's OUT bytes
DECODE = "repro_torch.layer.decode"
EPILOGUE = "repro_torch.layer.epilogue"
ENCODE = "repro_torch.layer.encode"
UNPACK = "repro_torch.layer.unpack"
# the spans whose ``bytes`` were written by staging and the codecs: into
# the DRAM stack, or (the ``cuda`` backend's operand) beside it
WRITERS = (STACK, STAGE, ENCODE)


def traced_spans(rec: dict) -> Optional[List[dict]]:
    """The spans of the traced calls, in start order, or None."""
    tr = rec.get("trace")
    if not tr or not tr["device"]:
        return None
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    spans = tracing.snapshot()["spans"]
    roots = {s["id"] for s in spans
             if s["name"] == ROOT and s["parent"] is None}
    if len(roots) != tr["calls"]:
        return None
    return [s for s in spans if s["call"] in roots]


def device_ms_per_kimg(rec: dict, names: Iterable[str]) -> Optional[float]:
    """Device milliseconds of the spans named ``names``, per 1,000 images
    of the traced calls; None where a span has no device time."""
    spans = traced_spans(rec)
    if spans is None:
        return None
    names = set(names)
    times = [s["device_ms"] for s in spans if s["name"] in names]
    if not times or any(t is None for t in times):
        return None
    return sum(times) / (rec["trace"]["images"] / 1e3)


def copy_device_ms_per_kimg(rec: dict) -> Optional[float]:
    """The images to the device and the logits to the host."""
    return device_ms_per_kimg(rec, (INPUT, OUTPUT))


def stack_clone_device_ms_per_kimg(rec: dict) -> Optional[float]:
    """The DRAM stack made: allocated on the ``cuda`` backend, which
    copies nothing into it (the interpreters clone the image into every
    row)."""
    return device_ms_per_kimg(rec, (STACK,))


def stage_device_ms_per_kimg(rec: dict) -> Optional[float]:
    """Each layer's input staged (one ``vta_stage`` gather of its operand,
    or of its INP region on the interpreters; on an older tree the im2row
    or flatten, binarise and INP write) and a residual layer's RES."""
    return device_ms_per_kimg(rec, (STAGE,))


def codec_device_ms_per_kimg(rec: dict) -> Optional[float]:
    """OUT written, and the last layer's OUT read back into the logits
    (on an older tree also INP decoded into the kernel's operand, and
    every layer's OUT read back into its output)."""
    return device_ms_per_kimg(rec, (DECODE, ENCODE, UNPACK))


def epilogue_device_ms_per_kimg(rec: dict) -> Optional[float]:
    """The ACC preload add, the TensorAlu ops and the commit of the layers
    the kernel does not fuse."""
    return device_ms_per_kimg(rec, (EPILOGUE,))


def serve_host_ms_per_call(rec: dict) -> Optional[float]:
    """Host milliseconds of the root span less its ``serve.output`` span
    (the synchronising copy of the logits, where the host waits for the
    device), a traced call."""
    traced = traced_spans(rec)
    if traced is None:
        return None
    ns = sum((s["end_ns"] - s["start_ns"]) * (1 if s["name"] == ROOT
                                              else -1)
             for s in traced if s["name"] in (ROOT, OUTPUT))
    return ns / 1e6 / rec["trace"]["calls"]


def stack_bytes_per_image(rec: dict) -> Optional[float]:
    """Bytes staging and the codecs write, per image: the operand (INP's
    bytes: beside the stack on the ``cuda`` backend, into it on the
    interpreters) and RES, OUT, and the image cloned into the row on a
    backend that clones it."""
    traced = traced_spans(rec)
    if traced is None:
        return None
    total = sum(s["attrs"]["bytes"] for s in traced if s["name"] in WRITERS)
    return total / rec["trace"]["images"]


READERS = {f.__name__: f for f in (
    copy_device_ms_per_kimg, stack_clone_device_ms_per_kimg,
    stage_device_ms_per_kimg, codec_device_ms_per_kimg,
    epilogue_device_ms_per_kimg, serve_host_ms_per_call,
    stack_bytes_per_image)}
