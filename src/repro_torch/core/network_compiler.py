"""Multi-layer network compilation + device-resident serving (paper §4.2).

``compile_network``, ``calibrate_network`` and ``calibrate_network_shifts``
are the reference's host-side numpy compiler, copied: every layer compiles
against one shared DRAM allocation, so the port emits byte-identical
programs (``tests/test_torch_compiler.py``).

Serving differs from the reference in where the work happens.  The
reference stages every layer's input on the host between VTA executions;
here the whole ``(batch, nbytes)`` DRAM stack lives on the device for the
whole network: images come in once, each layer's input is gathered in one
``vta_stage`` launch from the OUT bytes its producer committed to the stack
(or from the images, for the first layer), a residual layer's RES in one
more, the layer executes, and only the logits come back.  Each gather goes
through a table built once per compiled image by running the torch staging
functions (:mod:`repro_torch.core.staging`: OUT decode, im2row, the tiled
pool's rows, pad and split) over an index tensor, so the layout keeps one
definition.  A layer executes on one of the reference's backends, with
``cuda`` in the place of ``pallas``: ``cuda`` (the default) as one
``vta_gemm`` launch over the gathered operands plus its TensorAlu epilogue
(:mod:`repro_torch.core.cuda_backend`); ``batched``, ``fast`` and
``oracle`` as the instruction interpreters
(:mod:`repro_torch.core.fast_simulator`, :mod:`~repro_torch.core.simulator`),
whose input is gathered into each row's INP region instead, with the
reference's ``fault_hook`` and ``count_overflows``.  ``guard=`` routes a
serve through :mod:`repro_torch.harden`.

A program is a DAG schedule: layer k reads its input from the semantic
output of layer ``input_sources[k]`` (``-1`` is the network input) and, for
a residual layer, stages the output of ``residual_sources[k]`` into its
``res`` region as the second ALU operand.  ``compile_network`` builds the
linear chain (both lists ``None``: layer k feeds layer k+1); the graph
front end (:func:`repro_torch.graph.compile_graph`) builds the DAG of the
residual networks.  Every layer's OUT region is its own, so a layer's
output stays in the stack for every later layer that reads it.

The device image is the programs' segments placed in one DRAM image and
uploaded once per device; it is rebuilt when a segment is replaced (a
segment is an immutable ``bytes`` object, so a fault or a restore is a new
object).  Each layer's constants (:class:`~repro_torch.core.cuda_backend.
LayerConsts`: the kernel's weights and fused bias, the image its epilogue
reads the ACC preload from, and whether the layer fuses: a row-broadcast
bias, zero pad rows) depend only on that image, which serving never
writes outside the INP and RES regions, so they are read once per image
and cached with it.  The layers' gather tables follow the compiled layout
alone, so they are built once per device and kept when a segment is
replaced.  Serving a batch then reads nothing back but the logits.  The ``cuda`` backend serves from
them over a stack that holds only what varies by image: it is allocated,
not a copy of the image, and the gathers, the kernels and the encode write
every byte of it that is read (its INP regions are neither written nor
read: the operands are gathered beside it).  The interpreters execute instructions that load WGT, ACC, UOP and
INSN from DRAM, so their stacks hold the whole image in every row.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import DeviceLike, device_of, resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.vta_stage import StageTable

from . import staging
from .conv_lowering import mat2tensor
from .cuda_backend import (LayerConsts, _decode_acc32, _decode_inp,
                           _execute_stack, _region, layer_consts, plan_cuda)
from .cycle_model import CycleReport, analyze_programs
from .dram import DramAllocator
from .errors import CompileError
from .hwconfig import VTAConfig, vta_default
from .layer_compiler import CompiledLayer, LayerSpec, compile_layer
from .simulator import SimReport, make_simulator, run_instructions

# The reference's backend sets, with ``cuda`` in the place of ``pallas``:
# ``serve`` executes a (batch, nbytes) DRAM stack — only the two batch
# engines can; ``serve_one`` runs the per-image interpreters or the kernel.
SERVE_BACKENDS = ("batched", "cuda")
SERVE_ONE_BACKENDS = ("oracle", "fast", "cuda")
# ``verify`` runs the compile-time input on any backend
VERIFY_BACKENDS = ("oracle", "fast", "batched", "cuda")


@dataclasses.dataclass(frozen=True)
class LayerStage:
    """A layer's gathers (:meth:`NetworkProgram.stage_tables`): ``inp``,
    its input (the GEMM operand, or the INP region in block order), and
    ``res``, its RES region (None where the layer joins no residual)."""

    inp: StageTable
    res: Optional[StageTable]

    @property
    def nbytes(self) -> int:
        """Bytes one image's gathers write."""
        return self.inp.index.numel() + (
            4 * self.res.index.numel() if self.res is not None else 0)

    @property
    def contiguous(self) -> float:
        """The share of the 16-byte chunks written that one contiguous
        load serves."""
        tables = [t for t in (self.inp, self.res) if t is not None]
        return (sum(t.contiguous for t in tables)
                / sum(t.chunks for t in tables))


@dataclasses.dataclass
class _DeviceEntry:
    """One device's cache of a compiled image: the segments it was built
    from, the DRAM image uploaded and every layer's :class:`LayerConsts`
    over it (None until the cuda backend first asks)."""

    segments: tuple
    image: torch.Tensor
    consts: Optional[List[LayerConsts]] = None


@dataclasses.dataclass
class NetworkProgram:
    """Everything needed to run a compiled network on a device.

    ``input_sources``/``residual_sources`` generalise the chain to a DAG
    schedule (graph lowering): layer *k* reads its input from the semantic
    output of layer ``input_sources[k]`` (``-1`` = the network input) and —
    when ``residual_sources[k]`` is not None — stages that layer's output
    as its residual operand.  ``None`` for both fields keeps the classic
    linear chain (layer k feeds layer k+1).
    """

    config: VTAConfig
    allocator: DramAllocator
    layers: List[CompiledLayer]
    input_tensor: np.ndarray
    input_sources: Optional[List[int]] = None
    residual_sources: Optional[List[Optional[int]]] = None
    # Per device: the image's entry (:class:`_DeviceEntry`), filled on
    # first use.  Serving threads may both miss and both build an entry or
    # a part of it; each stores a complete value in one assignment, so the
    # race only duplicates work (the engine's warm-up fills it before its
    # workers start).
    _device_images: Dict[str, "_DeviceEntry"] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)
    # Per (device, block order): the layers' gathers (:meth:`stage_tables`).
    # They follow the compiled layout, not the segments' bytes, so a
    # replaced segment (an injected fault, a restore) keeps them.
    _stages: Dict[Tuple[str, bool], List["LayerStage"]] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)

    def _sources(self) -> List[int]:
        if self.input_sources is not None:
            return self.input_sources
        return list(range(-1, len(self.layers) - 1))

    def _res_sources(self) -> List[Optional[int]]:
        if self.residual_sources is not None:
            return self.residual_sources
        return [None] * len(self.layers)

    # ------------------------------------------------------------------
    def gemm_loops(self) -> int:
        """§5.1 metric over the whole network (LeNet-5: 2942)."""
        return sum(l.program.gemm_loops() for l in self.layers)

    def gemm_loops_per_layer(self) -> List[int]:
        return [l.program.gemm_loops() for l in self.layers]

    def chunks_per_layer(self) -> List[int]:
        """SRAM chunks per layer (§3.3 "steps 2 to 5 must be repeated") —
        > 1 anywhere means the network genuinely exceeds a single SRAM
        residency and exercises the multi-chunk compiler."""
        return [l.n_chunks for l in self.layers]

    def cycle_report(self) -> CycleReport:
        return analyze_programs([l.program for l in self.layers])

    def plans(self) -> List[object]:
        """Per-layer compiled instruction plans, cached on the layer
        programs — the compile-once/serve-many contract: the returned
        objects are identical across repeated interpreter serves."""
        from .fast_simulator import plan_for
        return [plan_for(layer.program) for layer in self.layers]

    def input_signature(self) -> Tuple[Tuple[int, ...], np.dtype]:
        """(shape, dtype) one request image must have — the admission
        contract the serving engine (:mod:`repro_torch.serving.vta`)
        validates at submit time instead of failing layers deep into
        staging."""
        return tuple(self.input_tensor.shape), np.dtype(np.int8)

    def plan_shapes(self) -> List[Dict[str, int]]:
        """Per-layer compiled geometry the serving layer batches against:
        INP/OUT (and residual) region sizes plus chunk counts.  Purely
        introspective — reading it never compiles or invalidates plans."""
        shapes: List[Dict[str, int]] = []
        for layer in self.layers:
            regions = layer.program.regions
            shapes.append({
                "name": layer.spec.name,
                "inp_nbytes": regions["inp"].nbytes,
                "out_nbytes": regions["out"].nbytes,
                "res_nbytes": (regions["res"].nbytes
                               if "res" in regions else 0),
                "n_chunks": layer.n_chunks,
            })
        return shapes

    def padded_batch_sizes(self, max_batch: int) -> Tuple[int, ...]:
        """The closed set of stack shapes the engine serves at: powers of
        two up to ``max_batch`` (plus ``max_batch`` itself when it is not
        a power of two).  Padding a formed batch up to the next rung
        keeps the compile-once contract — the device sees a small fixed
        family of ``(B, nbytes)`` stacks (and ``vta_gemm`` plans) instead
        of one shape per occupancy."""
        if max_batch < 1:
            raise CompileError(
                f"padding ladder needs max_batch >= 1, got {max_batch} "
                f"(a degenerate ladder would defer the failure to "
                f"padded_size deep inside a worker)",
                constraint="ladder-max-batch")
        sizes = []
        b = 1
        while b < max_batch:
            sizes.append(b)
            b *= 2
        sizes.append(max_batch)
        return tuple(sizes)

    def dram_image(self) -> np.ndarray:
        image = np.zeros(self.allocator.image_size(), dtype=np.uint8)
        for layer in self.layers:
            layer.program.place_segments(image)
        return image

    # ------------------------------------------------------- serving --
    def _segments(self) -> tuple:
        return tuple((name, data) for layer in self.layers
                     for name, data in layer.program.segments.items())

    def _device_entry(self, dev: torch.device) -> "_DeviceEntry":
        """This device's cache entry, rebuilt when a segment was replaced
        since the image was uploaded (compared by identity: segments are
        immutable ``bytes``)."""
        segments = self._segments()
        cached = self._device_images.get(device_of(dev))
        if cached is None or len(cached.segments) != len(segments) or any(
                a[0] != b[0] or a[1] is not b[1]
                for a, b in zip(cached.segments, segments)):
            cached = _DeviceEntry(segments, torch.from_numpy(
                self.dram_image()).to(dev))
            self._device_images[device_of(dev)] = cached
        return cached

    def _device_image(self, device: torch.device) -> torch.Tensor:
        """The DRAM image on ``device``, uploaded once per image."""
        return self._device_entry(device).image

    def layer_consts(self, device: DeviceLike = None) -> List[LayerConsts]:
        """Each layer's :class:`LayerConsts` over the compiled image on
        ``device``, read once per image and cached with it.  A served
        stack's rows all stand for that image with only the INP and RES
        regions restaged (their padding zero), so the image's constants
        are the stack's for every batch."""
        entry = self._device_entry(resolve_device(device))
        if entry.consts is None:
            entry.consts = [layer_consts(l.program, entry.image)
                            for l in self.layers]
        return entry.consts

    def stage_tables(self, device: DeviceLike = None, *,
                     block_order: bool = False) -> List["LayerStage"]:
        """Each layer's gathers on ``device``, built once per compiled
        network and device (:meth:`_build_stages`): its GEMM operand,
        row-major (Mp, Kp) as ``vta_gemm`` takes it, or with
        ``block_order`` its INP region's bytes, which the instruction
        interpreters read (the same entries, permuted); and a residual
        layer's RES region."""
        dev = resolve_device(device)
        key = (device_of(dev), block_order)
        stages = self._stages.get(key)
        if stages is None:
            stages = [LayerStage(s.inp.to(dev),
                                 s.res.to(dev) if s.res is not None else None)
                      for s in self._build_stages(block_order)]
            self._stages[key] = stages
        return stages

    def _build_stages(self, block_order: bool) -> List["LayerStage"]:
        """The gathers of every layer, on the host: the torch staging
        functions run once over the index of each layer's source
        (:func:`staging.out_index` of the layer it reads, or
        :func:`staging.input_index`), so a served batch's layout has the
        one definition those functions give it."""
        bs = self.config.block_size
        index: Dict[int, torch.Tensor] = {
            -1: staging.input_index(self.input_tensor.shape[1:])}

        def source(j: int) -> torch.Tensor:
            if j not in index:
                index[j] = staging.out_index(self.layers[j])
            return index[j]

        stages = []
        for layer, src, rsrc in zip(self.layers, self._sources(),
                                    self._res_sources()):
            p = plan_cuda(layer.program)
            inp = staging.operand_table(layer, source(src), bs)
            if (inp.index.numel() != p.inp[1]
                    or inp.rows != p.alpha * p.row_height):
                raise CompileError(
                    f"layer {layer.spec.name!r}: a staged operand of "
                    f"{inp.rows} rows and {inp.index.numel()} bytes, the "
                    f"INP region holds {p.inp[1]} in {p.alpha} block rows "
                    f"of {p.row_height}", layer=layer.spec.name,
                    constraint="stage-geometry")
            if block_order:
                inp = staging.block_order(inp, p.row_height, bs)
            res = None
            if rsrc is not None:
                res = staging.residual_table(layer, source(rsrc), bs)
                if p.res is None or 4 * res.index.numel() != p.res[1]:
                    raise CompileError(
                        f"layer {layer.spec.name!r}: a staged residual of "
                        f"{4 * res.index.numel()} bytes, the RES region "
                        f"holds {p.res and p.res[1]}", layer=layer.spec.name,
                        constraint="stage-geometry")
            stages.append(LayerStage(inp, res))
        return stages

    def _as_image_batch(self, images, device: torch.device) -> torch.Tensor:
        """Normalise a request batch to one ``(B,) + input_shape[1:]`` int8
        tensor on ``device``: a sequence of per-image tensors (each shaped
        like ``input_tensor``), or one stacked array or tensor whose leading
        axis is the batch."""
        want = tuple(self.input_tensor.shape)
        if isinstance(images, (np.ndarray, torch.Tensor)):
            shape = tuple(images.shape)
            if shape[1:] == want:                        # (B,) + full shape
                batch = images
            elif len(shape) == len(want) and shape[1:] == want[1:]:
                batch = images                           # batch axis leads
            else:
                raise ValueError(
                    f"cannot interpret stacked input of shape {shape} "
                    f"as a batch of {want} images")
        else:
            imgs = [np.asarray(img) for img in images]
            if not imgs:
                raise ValueError("empty request batch")
            for img in imgs:
                if img.shape != want:
                    raise ValueError(
                        f"request shape {img.shape} does not match the "
                        f"compiled input shape {want}")
            batch = np.stack(imgs)
        batch = torch.as_tensor(batch).to(torch.int8)
        return batch.reshape((batch.shape[0],) + want[1:]).to(device)

    def _run_chain(self, stack: torch.Tensor, first: torch.Tensor,
                   execute, *, operands: bool, check_chaining: bool = False
                   ) -> Tuple[torch.Tensor, List[SimReport]]:
        """Run every layer over the stack in place, in schedule order: stage
        its input, and its residual operand if it has one, with one
        ``vta_stage`` gather each from ``first`` (the network input) or the
        OUT bytes an earlier layer committed to the stack (a layer's OUT
        region is its own, so it stays until the call ends), then
        ``execute(k, layer, stack, a)``, which writes the layer's OUT region
        and returns its report.  With ``operands`` (the ``cuda`` backend)
        the input is gathered into ``a``, the (B·Mp, Kp) operand of
        ``vta_gemm``; without it, into each row's INP region, which the
        interpreters read (``a`` None).  Returns the last layer's semantic
        outputs (on the device) and the per-layer batch-total reports.
        ``check_chaining`` asserts each staged input and residual equals the
        matrix the layer was compiled against — a divergence is a
        compilation bug (the paper's traceability)."""
        reports: List[SimReport] = []
        stages = self.stage_tables(stack.device, block_order=not operands)
        srcs, rsrcs = self._sources(), self._res_sources()
        b = stack.shape[0]
        inputs = first.reshape(b, -1)
        for k, (layer, stage) in enumerate(zip(self.layers, stages)):
            p = plan_cuda(layer.program)
            inp, res = stage.inp, stage.res
            with tracing.span("repro_torch.layer", k=k,
                              name=layer.spec.name):
                with tracing.span("repro_torch.layer.stage",
                                  bytes=b * stage.nbytes,
                                  contiguous=stage.contiguous):
                    a = None
                    src = inputs if srcs[k] < 0 else stack
                    if operands:
                        a = torch.empty((b * inp.rows, inp.cols * 16),
                                        dtype=torch.int8, device=stack.device)
                        kernel_ops.vta_stage(src, inp, a.view(b, -1))
                    else:
                        kernel_ops.vta_stage(src, inp,
                                             _region(stack, p.inp, torch.int8))
                    if res is not None:
                        kernel_ops.vta_stage(
                            inputs if rsrcs[k] < 0 else stack, res,
                            _region(stack, p.res, torch.int32))
                    if check_chaining:
                        self._check_staged(k, layer, stack, a)
                reports.append(execute(k, layer, stack, a))
                if k == len(self.layers) - 1:
                    with tracing.span("repro_torch.layer.unpack"):
                        sem = staging.decode_layer_output_batch(
                            layer, staging.decode_out_region_batch(
                                layer.program, stack))
        return sem, reports

    def _check_staged(self, k: int, layer: CompiledLayer,
                      stack: torch.Tensor, a: Optional[torch.Tensor]) -> None:
        """The first image's staged input (``a``'s first operand, or the
        INP region) and residual (the RES region) against the matrices
        ``layer`` was compiled against."""
        p = plan_cuda(layer.program)
        staged = (a[:p.alpha * p.row_height] if a is not None
                  else _decode_inp(stack[:1], p)[0])
        m, n = layer.input_matrix.shape
        np.testing.assert_array_equal(
            staged[:m, :n].cpu().numpy(), layer.input_matrix,
            err_msg=f"layer {self._sources()[k]}->{k} reshaping mismatch")
        if self._res_sources()[k] is not None:
            m, n = layer.residual_matrix.shape
            np.testing.assert_array_equal(
                _decode_acc32(stack[:1], p, p.res)[0, :m, :n].cpu().numpy(),
                layer.residual_matrix,
                err_msg=f"layer {layer.spec.name!r}: residual operand "
                        f"mismatch")

    # ------------------------------------------------------- executors --
    @staticmethod
    def _layer_hook(fault_hook, k: int):
        """Adapt a network-level ``hook(sim, layer_idx, insn_idx)`` to the
        simulator-level ``hook(sim, insn_idx)`` for layer ``k`` — the
        injection/watchdog point of the harden subsystem."""
        if fault_hook is None:
            return None
        return lambda sim, i: fault_hook(sim, k, i)

    def _kernel_executor(self, dev: torch.device):
        """Each layer as one ``vta_gemm`` launch (plus its epilogue) over
        the stack, with the layer's cached :class:`LayerConsts`: the
        stack's WGT and ACC are not read."""
        consts = self.layer_consts(dev)
        return lambda k, layer, stack, a: _execute_stack(
            layer.program, stack, a, consts[k], saturate=False)

    def _interpreter(self, backend: str, fault_hook, count_overflows: bool):
        """Each layer on an instruction interpreter over the stack, its
        plan cached on the program: ``batched`` runs the whole stack in
        place on the stack's device; ``fast`` (on that device) and
        ``oracle`` (host numpy) run the one row of a ``serve_one`` stack,
        which gets the interpreter's DRAM back."""
        from .fast_simulator import BatchFastSimulator, plan_for

        def execute(k: int, layer: CompiledLayer, stack: torch.Tensor,
                    a: None) -> SimReport:
            prog = layer.program
            hook = self._layer_hook(fault_hook, k)
            if backend == "batched":
                sim = BatchFastSimulator(self.config, stack, copy_dram=False,
                                         count_overflows=count_overflows,
                                         device=stack.device)
                return sim.run(prog.instructions, plan=plan_for(prog),
                               fault_hook=hook)
            row = stack[0] if backend == "fast" else stack[0].cpu().numpy()
            sim = make_simulator(self.config, row, backend=backend,
                                 count_overflows=count_overflows,
                                 device=stack.device)
            report = run_instructions(sim, prog.instructions, program=prog,
                                      fault_hook=hook)
            stack[0] = torch.as_tensor(sim.dram).to(stack.device)
            return report

        return execute

    @staticmethod
    def _refuse_hooks(fault_hook, count_overflows: bool) -> None:
        """The ``cuda`` backend executes whole programs, as ``pallas``
        does in the reference: there is no instruction to hook or count."""
        if fault_hook is not None:
            raise CompileError(
                "fault_hook requires per-instruction execution; the cuda "
                "backend has no instruction stream to hook (use the "
                "'batched' or 'fast' interpreter)",
                constraint="serve-fault-hook")
        if count_overflows:
            raise CompileError(
                "overflow counters need per-instruction execution; the "
                "cuda backend executes whole programs (use the 'batched' "
                "or 'fast' interpreter)",
                constraint="serve-count-overflows")

    def _outputs(self, sem: torch.Tensor) -> np.ndarray:
        """Device semantic outputs → the reference's stacked host form:
        ``(B, rows, F)`` for fc, ``(B, 1, F, H, W)`` for conv.

        The copy to the host waits for the device, so ``serve`` returns
        only once the batch's work is done.  The serving engine's
        ``complete_t`` and ``calibrate_service_model``'s timings rely on
        that: keep the synchronising copy here."""
        with tracing.span("repro_torch.serve.output", bytes=sem.nbytes):
            host = sem.cpu().numpy()
        if self.layers[-1].spec.kind == "conv":
            host = host[:, None]
        return host

    # ------------------------------------------------------- serving --
    def serve(self, images, *, backend: str = "cuda",
              device: DeviceLike = None, fault_hook=None,
              count_overflows: bool = False, guard=None):
        """Compile-once/serve-many batched inference on the device.

        ``images`` is a batch of requests (see :meth:`_as_image_batch`).
        One ``(batch, nbytes)`` DRAM stack on ``device`` (the card unless
        the caller names another) moves through the layer chain.
        ``backend="cuda"`` (default) executes each layer as one stacked
        ``vta_gemm`` launch over the whole batch; ``backend="batched"``
        runs the batched instruction interpreter on the device, one plan
        per layer over the whole stack, with ``fault_hook(sim, layer_idx,
        insn_idx)`` and ``count_overflows`` as in the reference.  Returns
        ``(stacked outputs, per-layer batch-total reports)``, outputs on
        the host with the request index leading — bit-identical to the
        reference's ``serve``.

        ``guard`` (a :class:`repro_torch.harden.GuardPolicy`) needs
        ``backend="batched"``: the batch goes through the integrity-guarded
        path and the call returns ``(outputs, reports, guard_reports)``
        with one :class:`~repro_torch.harden.GuardReport` per request."""
        if guard is not None:
            if backend != "batched":
                raise CompileError(
                    "guarded serving runs on the batched instruction "
                    "interpreter (its watchdog and injection hooks are "
                    "per-instruction); drop guard= or backend="
                    f"{backend!r}", constraint="serve-guard-backend")
            from repro_torch.harden import guards as _guards
            return _guards.guarded_serve(self, images, guard,
                                         fault_hook=fault_hook,
                                         device=device)
        if backend not in SERVE_BACKENDS:
            raise CompileError(
                f"serve supports backend in {SERVE_BACKENDS} (the "
                f"per-image backends {SERVE_ONE_BACKENDS} are "
                f"serve_one()'s), got {backend!r}",
                constraint="serve-backend")
        if backend == "cuda":
            self._refuse_hooks(fault_hook, count_overflows)
        dev = resolve_device(device)
        with tracing.span("repro_torch.serve", device=dev,
                          backend=backend) as call:
            with tracing.span("repro_torch.serve.input") as sp:
                batch = self._as_image_batch(images, dev)
                sp.set(bytes=batch.nbytes)
            call.set(batch=batch.shape[0])
            with tracing.span("repro_torch.serve.stack") as sp:
                image = self._device_image(dev)
                if backend == "cuda":
                    # nothing to copy: every byte the chain reads is
                    # written by staging, the kernels or the encode first
                    stack = torch.empty((batch.shape[0], image.shape[0]),
                                        dtype=torch.uint8, device=dev)
                    execute = self._kernel_executor(dev)
                    sp.set(bytes=0)
                else:
                    stack = image.expand(batch.shape[0], -1).clone()
                    execute = self._interpreter(backend, fault_hook,
                                                count_overflows)
                    sp.set(bytes=stack.nbytes)
            sem, reports = self._run_chain(stack, batch, execute,
                                           operands=backend == "cuda")
            return self._outputs(sem), reports

    def serve_one(self, image, *, backend: str = "cuda",
                  device: DeviceLike = None, fault_hook=None,
                  count_overflows: bool = False, guard=None):
        """One inference request through the layer chain on ``device``;
        returns the request's semantic output as the reference does.

        ``backend`` is one of :data:`SERVE_ONE_BACKENDS` — ``"cuda"``
        (default, a batch of one through :meth:`serve`'s kernel path),
        ``"fast"`` (the vectorised interpreter on the device) or
        ``"oracle"`` (the per-struct reference interpreter, on the host).
        All are bit-identical.

        ``guard`` (a :class:`repro_torch.harden.GuardPolicy`) routes the
        request through the integrity-guarded path and changes the return
        value to ``(output, GuardReport)``.  ``fault_hook(sim, layer_idx,
        insn_idx)`` fires before each instruction of each layer on the
        interpreters; the ``cuda`` backend refuses it."""
        if backend not in SERVE_ONE_BACKENDS:
            raise CompileError(
                f"serve_one supports backend in {SERVE_ONE_BACKENDS}, got "
                f"{backend!r} (the batched engine is serve()'s)",
                constraint="serve-one-backend")
        if guard is not None:
            from repro_torch.harden import guards as _guards
            return _guards.guarded_serve_one(
                self, image, guard, backend=backend, fault_hook=fault_hook,
                device=device)
        if backend == "cuda":
            self._refuse_hooks(fault_hook, count_overflows)
            outs, _ = self.serve([np.asarray(image)], backend=backend,
                                 device=device)
            return outs[0]
        dev = resolve_device(device)
        first = self._as_image_batch([np.asarray(image)], dev)
        stack = self._device_image(dev).reshape(1, -1).clone()
        sem, _ = self._run_chain(stack, first, self._interpreter(
            backend, fault_hook, count_overflows), operands=False)
        return self._outputs(sem)[0]

    def run_functional(self, *, check_chaining: bool = True,
                       backend: str = "cuda", device: DeviceLike = None,
                       fault_hook=None
                       ) -> Tuple[np.ndarray, List[SimReport]]:
        """Fig. 12 over the compile-time input: one execution per layer with
        the reshaping between, asserting (``check_chaining``) that each
        staged input equals the matrix the layer was compiled against.
        ``backend`` is one of :data:`SERVE_ONE_BACKENDS`."""
        if backend not in SERVE_ONE_BACKENDS:
            raise CompileError(
                f"run_functional supports backend in {SERVE_ONE_BACKENDS}, "
                f"got {backend!r}", constraint="run-functional-backend")
        return self._functional(backend, device, fault_hook, check_chaining)

    def _functional(self, backend: str, device: DeviceLike, fault_hook,
                    check_chaining: bool
                    ) -> Tuple[np.ndarray, List[SimReport]]:
        if backend == "cuda":
            self._refuse_hooks(fault_hook, False)
        dev = resolve_device(device)
        first = self._as_image_batch([self.input_tensor], dev)
        stack = self._device_image(dev).reshape(1, -1).clone()
        execute = (self._kernel_executor(dev) if backend == "cuda" else
                   self._interpreter(backend, fault_hook, False))
        sem, reports = self._run_chain(stack, first, execute,
                                       operands=backend == "cuda",
                                       check_chaining=check_chaining)
        return self._outputs(sem)[0], reports

    def verify(self, *, backend: str = "cuda", device: DeviceLike = None
               ) -> Tuple[np.ndarray, List[SimReport]]:
        """Run the chain over the compile-time input, each staged input
        checked as :meth:`run_functional` checks it, and assert the final
        output equals the compiler's reference of the last layer.
        ``backend`` is one of :data:`VERIFY_BACKENDS` (``batched`` over a
        stack of one).  Returns (final output, reports)."""
        if backend not in VERIFY_BACKENDS:
            raise CompileError(
                f"verify supports backend in {VERIFY_BACKENDS}, got "
                f"{backend!r}", constraint="verify-backend")
        out, reports = self._functional(backend, device, None, True)
        last = self.layers[-1]
        expected = last.ref_output_matrix
        if last.spec.kind == "conv":
            expected = mat2tensor(expected, last.out_h, last.out_w)
        np.testing.assert_array_equal(
            out, expected, err_msg=f"network output on {backend!r} differs "
                                   f"from the compiler's reference")
        return out, reports


def calibrate_network(specs: Sequence[LayerSpec],
                      images: Sequence[np.ndarray], *,
                      margin: int = 1, saturate: bool = False
                      ) -> Tuple[List[int], List[List[np.ndarray]]]:
    """Static per-layer requant shifts from a calibration set (§4.2
    discipline: shifts are fixed at compile time; the margin bit guards
    unseen inputs against int8 wrap-around).  Model-agnostic: works for
    any conv/fc chain with valid or same padding and avg/max pooling.

    Layer k's input depends on shifts < k, so calibration is sequential,
    and the images advance through each layer under the *device's*
    requant semantics (:func:`repro_torch.core.layout.requant_int8` — wrap
    by default, clip under ``saturate=True``), with pinned
    ``spec.requant_shift`` values honoured exactly as :func:`compile_layer`
    honours them.

    Returns ``(shifts, traces)`` where ``traces[k][i]`` is layer ``k``'s
    semantic output for calibration image ``i``.
    """
    from .conv_lowering import mat2tensor
    from .layer_compiler import (choose_requant_shift, layer_matrices,
                                 pool_divisor, pool_plan_for,
                                 reference_layer_acc)
    from .layout import requant_int8

    shifts: List[int] = []
    traces: List[List[np.ndarray]] = []
    currents = [np.asarray(img, np.int8) for img in images]
    for spec in specs:
        pool_div = 0
        accs = []
        geos = []
        for cur in currents:
            A, B, geo = layer_matrices(spec, cur)
            plan = pool_plan_for(spec, geo)
            pool_div = pool_divisor(plan)
            accs.append(reference_layer_acc(A, B, spec.bias, spec.relu, plan))
            geos.append((geo, plan))
        if spec.requant_shift is not None:
            shift = spec.requant_shift
        else:
            stacked = np.concatenate([a.reshape(-1) for a in accs])
            shift = choose_requant_shift(stacked,
                                         already_shifted=pool_div) + margin
        shifts.append(shift)
        # advance every calibration image through this layer
        nxt = []
        for acc, (geo, plan) in zip(accs, geos):
            out = requant_int8(acc >> (pool_div + shift), saturate=saturate)
            if spec.kind == "conv":
                oh = plan.out_h if plan else geo.out_h
                ow = plan.out_w if plan else geo.out_w
                nxt.append(mat2tensor(out, oh, ow))
            else:
                nxt.append(out)
        currents = nxt
        traces.append(list(currents))
    return shifts, traces


def calibrate_network_shifts(specs: Sequence[LayerSpec],
                             images: Sequence[np.ndarray],
                             margin: int = 1, *,
                             saturate: bool = False) -> List[int]:
    """Shift list only — see :func:`calibrate_network`."""
    return calibrate_network(specs, images, margin=margin,
                             saturate=saturate)[0]


def compile_network(specs: Sequence[LayerSpec], input_tensor: np.ndarray, *,
                    cfg: Optional[VTAConfig] = None,
                    dram_offset: int = 0,
                    schedule: str = "serialized") -> NetworkProgram:
    """Compile a network: every layer against one shared DRAM allocation,
    each layer's input taken from the previous layer's reference output."""
    cfg = cfg or vta_default()
    alloc = DramAllocator(offset=dram_offset, page_bytes=cfg.page_bytes)
    layers: List[CompiledLayer] = []
    current: np.ndarray = np.asarray(input_tensor, dtype=np.int8)
    for spec in specs:
        layer = compile_layer(spec, current, cfg=cfg, allocator=alloc,
                              schedule=schedule)
        layers.append(layer)
        # Reference output becomes the next layer's input (semantic form).
        ref = layer.ref_output_matrix
        if spec.kind == "conv":
            from .conv_lowering import mat2tensor
            current = mat2tensor(ref, layer.out_h, layer.out_w)
        else:
            current = ref
    return NetworkProgram(config=cfg, allocator=alloc, layers=layers,
                          input_tensor=np.asarray(input_tensor))
