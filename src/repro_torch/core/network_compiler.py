"""Multi-layer network compilation + device-resident serving (paper §4.2).

``compile_network``, ``calibrate_network`` and ``calibrate_network_shifts``
are the reference's host-side numpy compiler, copied: every layer compiles
against one shared DRAM allocation, so the port emits byte-identical
programs (``tests/test_torch_compiler.py``).

Serving differs from the reference in where the work happens.  The
reference stages every layer's input on the host between VTA executions;
here the whole ``(batch, nbytes)`` DRAM stack lives on the device for the
whole network: images come in once, each layer's im2row / pad / split /
binarise (:mod:`repro_torch.core.staging`), its execution and the OUT
decode all run in torch on that device, and only the logits come back.
A layer executes on one of the reference's backends, with ``cuda`` in the
place of ``pallas``: ``cuda`` (the default) as one ``vta_gemm`` launch
plus its TensorAlu epilogue (:mod:`repro_torch.core.cuda_backend`);
``batched``, ``fast`` and ``oracle`` as the instruction interpreters
(:mod:`repro_torch.core.fast_simulator`, :mod:`~repro_torch.core.simulator`)
with the reference's ``fault_hook`` and ``count_overflows``.  ``guard=``
routes a serve through :mod:`repro_torch.harden`.

A program is a DAG schedule: layer k reads its input from the semantic
output of layer ``input_sources[k]`` (``-1`` is the network input) and, for
a residual layer, stages the output of ``residual_sources[k]`` into its
``res`` region as the second ALU operand.  ``compile_network`` builds the
linear chain (both lists ``None``: layer k feeds layer k+1); the graph
front end (:func:`repro_torch.graph.compile_graph`) builds the DAG of the
residual networks.  A layer's output stays on the device only while a
later layer still reads it.

The device image is the programs' segments placed in one DRAM image and
uploaded once per device; it is rebuilt when a segment is replaced (a
segment is an immutable ``bytes`` object, so a fault or a restore is a new
object).  The fused-path decision of every layer (:class:`~repro_torch.
core.cuda_backend.StackForm`: uniform weights, a row-broadcast bias, zero
pad rows) depends only on that image, which serving never writes outside
the INP and RES regions, so it is read once per image and cached here;
serving a batch then reads nothing back but the logits.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.device import DeviceLike, device_of, resolve_device

from . import staging
from .conv_lowering import mat2tensor
from .cuda_backend import StackForm, _execute_stack, stack_form
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
    # The two caches below are filled on first use per device.  Serving
    # threads may both miss and both build an entry; each stores a complete
    # value in one dict assignment, so the race only duplicates work (the
    # engine's warm-up fills both before its workers start).
    # (segments it was built from, the DRAM image uploaded to the device)
    _device_images: Dict[str, Tuple[tuple, torch.Tensor]] = \
        dataclasses.field(default_factory=dict, repr=False, compare=False)
    # (that image, every layer's StackForm over it)
    _stack_forms: Dict[str, Tuple[torch.Tensor, List[StackForm]]] = \
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

    def _device_image(self, device: torch.device) -> torch.Tensor:
        """The DRAM image on ``device``, rebuilt only when a segment was
        replaced since it was uploaded (compared by identity: segments
        are immutable ``bytes``)."""
        key = device_of(device)
        segments = self._segments()
        cached = self._device_images.get(key)
        if cached is None or len(cached[0]) != len(segments) or any(
                a[0] != b[0] or a[1] is not b[1]
                for a, b in zip(cached[0], segments)):
            cached = (segments, torch.from_numpy(self.dram_image()).to(device))
            self._device_images[key] = cached
        return cached[1]

    def stack_forms(self, device: DeviceLike = None) -> List[StackForm]:
        """Each layer's :class:`StackForm` over the compiled image on
        ``device``, read once and cached.  A served stack is that image in
        every row with only the INP and RES regions restaged (zero-padded
        by :func:`staging.batch_matrix_to_binary`), so the image's answers
        are the stack's for every batch.  Read off one row, ``uniform_w``
        and ``uniform_bias`` are True by construction; only ``fuse_bias``
        comes from the image's data."""
        dev = resolve_device(device)
        key = device_of(dev)
        image = self._device_image(dev)
        cached = self._stack_forms.get(key)
        if cached is None or cached[0] is not image:
            cached = (image, [stack_form(l.program, image.reshape(1, -1))
                              for l in self.layers])
            self._stack_forms[key] = cached
        return cached[1]

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

    @staticmethod
    def _input_matrices(layer: CompiledLayer,
                        sem: torch.Tensor) -> torch.Tensor:
        """(B, M, K) input matrices of ``layer`` from the previous layer's
        semantic outputs: im2row (conv) or NCHW flatten (fc)."""
        spec = layer.spec
        if spec.kind == "conv":
            _, _, kh, kw = spec.weights.shape
            return staging.im2row_batch(sem, kh, kw, spec.stride,
                                        spec.padding)
        return sem.reshape(sem.shape[0], 1, -1)

    def _stage_layer_input_batch(self, stack: torch.Tensor,
                                 layer: CompiledLayer,
                                 A: torch.Tensor) -> None:
        """Batched §4.2 stage (ii) on the device: pad → split → binarise
        the (B, M, K) input matrices into the layer's INP region."""
        spec = layer.spec
        raw = staging.batch_matrix_to_binary(A, self.config.block_size,
                                             torch.int8)
        region = layer.program.regions["inp"]
        if raw.shape[1] != region.nbytes:
            raise ValueError(
                f"layer {spec.name!r}: staged input is {raw.shape[1]} "
                f"bytes, INP region holds {region.nbytes} — request shape "
                f"does not match the compiled geometry")
        start = region.phys_addr - self.allocator.offset
        stack[:, start:start + raw.shape[1]] = raw

    def _stage_residual_batch(self, stack: torch.Tensor,
                              layer: CompiledLayer,
                              sems: torch.Tensor) -> torch.Tensor:
        """Batched residual staging on the device: the skip activations
        ``sems`` → int32 ``(B, M, N)`` operands
        (:func:`staging.residual_operand_batch`) → ACC-format binary in the
        layer's ``res`` region.  Returns the staged operands."""
        R = staging.residual_operand_batch(layer.spec, sems,
                                           layer.residual_matrix.shape)
        raw = staging.batch_matrix_to_binary(R, self.config.block_size,
                                             torch.int32)
        region = layer.program.regions["res"]
        if raw.shape[1] != region.nbytes:
            raise ValueError(
                f"layer {layer.spec.name!r}: staged residual is "
                f"{raw.shape[1]} bytes, RES region holds {region.nbytes}")
        start = region.phys_addr - self.allocator.offset
        stack[:, start:start + raw.shape[1]] = raw
        return R

    def _last_reads(self) -> Dict[int, int]:
        """Layer index → the last layer that reads its output (the final
        layer's output is the network's and is kept to the end)."""
        last: Dict[int, int] = {len(self.layers) - 1: len(self.layers)}
        for k, (src, res) in enumerate(zip(self._sources(),
                                           self._res_sources())):
            for j in (src, res):
                if j is not None and j >= 0:
                    last[j] = max(last.get(j, k), k)
        return last

    def _run_chain(self, stack: torch.Tensor, first: torch.Tensor,
                   execute, *, check_chaining: bool = False
                   ) -> Tuple[torch.Tensor, List[SimReport]]:
        """Run every layer over the stack in place, in schedule order: stage
        its input from ``first`` (the network input) or an earlier layer's
        semantic outputs, stage its residual operand if it has one,
        ``execute(k, layer, stack)`` (which writes the layer's OUT region
        and returns its report), decode.  Returns the last layer's semantic
        outputs (on the device) and the per-layer batch-total reports.
        ``check_chaining`` asserts each staged input and residual equals the
        matrix the layer was compiled against — a divergence is a
        compilation bug (the paper's traceability)."""
        reports: List[SimReport] = []
        sems: Dict[int, torch.Tensor] = {}
        last = self._last_reads()
        srcs, rsrcs = self._sources(), self._res_sources()
        b = stack.shape[0]
        for k, layer in enumerate(self.layers):
            with tracing.span("repro_torch.layer", k=k,
                              name=layer.spec.name):
                regions = layer.program.regions
                staged = regions["inp"].nbytes + (
                    regions["res"].nbytes if rsrcs[k] is not None else 0)
                with tracing.span("repro_torch.layer.stage",
                                  bytes=b * staged):
                    sem_in = first if srcs[k] < 0 else sems[srcs[k]]
                    A = self._input_matrices(layer, sem_in)
                    if check_chaining:
                        np.testing.assert_array_equal(
                            A[0].cpu().numpy(), layer.input_matrix,
                            err_msg=f"layer {srcs[k]}->{k} reshaping "
                                    f"mismatch")
                    self._stage_layer_input_batch(stack, layer, A)
                    if rsrcs[k] is not None:
                        sem_res = first if rsrcs[k] < 0 else sems[rsrcs[k]]
                        R = self._stage_residual_batch(stack, layer, sem_res)
                        if check_chaining:
                            np.testing.assert_array_equal(
                                R[0].cpu().numpy(), layer.residual_matrix,
                                err_msg=f"layer {layer.spec.name!r}: "
                                        f"residual operand mismatch")
                reports.append(execute(k, layer, stack))
                with tracing.span("repro_torch.layer.unpack"):
                    out_mats = staging.decode_out_region_batch(
                        layer.program, stack)
                    sems[k] = staging.decode_layer_output_batch(layer,
                                                                out_mats)
            for j in [j for j in sems if last.get(j, k) <= k]:
                del sems[j]             # no later layer reads it
        return sems[len(self.layers) - 1], reports

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
        the stack, with the layer's cached :class:`StackForm`."""
        forms = self.stack_forms(dev)
        return lambda k, layer, stack: _execute_stack(
            layer.program, stack, saturate=False, form=forms[k])

    def _interpreter(self, backend: str, fault_hook, count_overflows: bool):
        """Each layer on an instruction interpreter over the stack, its
        plan cached on the program: ``batched`` runs the whole stack in
        place on the stack's device; ``fast`` (on that device) and
        ``oracle`` (host numpy) run the one row of a ``serve_one`` stack,
        which gets the interpreter's DRAM back."""
        from .fast_simulator import BatchFastSimulator, plan_for

        def execute(k: int, layer: CompiledLayer,
                    stack: torch.Tensor) -> SimReport:
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
                stack = self._device_image(dev).expand(
                    batch.shape[0], -1).clone()
                sp.set(bytes=stack.nbytes)
                execute = (self._kernel_executor(dev) if backend == "cuda"
                           else self._interpreter(backend, fault_hook,
                                                  count_overflows))
            sem, reports = self._run_chain(stack, batch, execute)
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
            backend, fault_hook, count_overflows))
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
