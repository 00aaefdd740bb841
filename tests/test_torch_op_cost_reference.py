"""The port's per-device cost against the reference's, for the eleven
smoke configs at a train, a prefill and a decode shape on a 2×2 mesh.

The port's side traces ``launch.specs.build_cell`` under a fake process
group of four ranks (every tensor on ``meta``, rank 0's ops); the
reference's lowers and compiles its ``build_cell`` on a
``jax.sharding.Mesh`` of four host devices — not ``make_production_mesh``,
whose ``Explicit`` axes fail under jax 0.9 (ROADMAP Queue 3, reference
fault 5) — and walks the HLO with a subclass of ``CostWalker`` that
counts only dots and convolutions.  The same ``ShapeSpec``s go to both
packages (added to the reference's ``SHAPES`` inside its subprocess).

Gated: the per-device matmul FLOPs agree within 0.5 % wherever the two
partitioners split every product alike — the seven dense configs at all
three shapes, the two MoE configs and rwkv6 at decode.  Reported side by
side, not gated, with the reason:

* mixtral and moonshot at train and prefill (fewer than 4096 tokens: one
  dispatch group that every rank holds): XLA contracts the expert
  up-projections over the whole ``d`` on every ``data`` rank, computing
  each slot twice at (2, 2); the port splits ``d`` over ``data`` as the
  weights are split (no expert weight gathered), as XLA itself does at
  decode.  The port counts 0.69–0.90 of the reference's matmul FLOPs.
* rwkv6 at train and prefill: XLA keeps the sequence split over
  ``model`` through the time mix (each rank projects its tokens to every
  channel) and runs the WKV on all heads on every ``model`` rank; the
  port gathers the sequence (the token shift runs along it), splits the
  projections' outputs and the WKV heads over ``model`` (0.82–0.98).
  At decode the two agree (1.0008).
* jamba at every shape: its MoE layers as above, and XLA splits the
  Mamba products otherwise than the port's ``d_inner`` split
  (0.78–1.005).

Total FLOPs (elementwise rules differ: XLA fuses), ``bytes_fused``
(XLA:CPU upcasts bf16 products to float32 and fuses; the port counts
the eager operands in the model's dtypes) and collective bytes by kind
(XLA emits ``all-to-all`` and ``collective-permute`` where DTensor does
not) are reported side by side, not gated.
"""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 600
TOL = 5e-3
ARCHS = ["whisper-base", "nemotron-4-340b", "qwen2.5-3b", "qwen1.5-110b",
         "gemma3-1b", "rwkv6-7b", "moonshot-v1-16b-a3b", "mixtral-8x22b",
         "internvl2-26b", "jamba-1.5-large-398b", "lm100m"]
SHAPES = {"cmp_train": (128, 8, "train"), "cmp_prefill": (128, 4, "prefill"),
          "cmp_decode": (256, 8, "decode")}
PARTITIONED_OTHERWISE = {
    **{(a, s): "one MoE dispatch group: XLA contracts the expert "
               "up-projections over the whole d on every data rank"
       for a in ("mixtral-8x22b", "moonshot-v1-16b-a3b")
       for s in ("cmp_train", "cmp_prefill")},
    **{("rwkv6-7b", s): "XLA keeps the time mix sequence-split and runs "
                        "the WKV on every head on every model rank"
       for s in ("cmp_train", "cmp_prefill")},
    **{("jamba-1.5-large-398b", s): "the MoE layers as above; XLA splits "
                                    "the Mamba products otherwise"
       for s in SHAPES},
}

_REFERENCE = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax
from jax.sharding import Mesh
from repro.configs import SHAPES, ShapeSpec, get_smoke
from repro.launch.specs import build_cell
from repro.analysis.hlo_cost import Cost, CostWalker, analyze_hlo, parse_module

shapes, archs, out = json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3]
for name, (s, b, kind) in shapes.items():
    SHAPES[name] = ShapeSpec(name, s, b, kind)


class DotWalker(CostWalker):
    """Only dots and convolutions (loops, fusions and calls walked)."""
    def op_cost(self, op, comp):
        if op.opcode in ("while", "fusion", "call", "map", "conditional",
                         "dot", "convolution"):
            return super().op_cost(op, comp)
        return Cost()


mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
res = {}
for arch in archs:
    for name in shapes:
        with jax.set_mesh(mesh):
            hlo = build_cell(arch, name, mesh, cfg=get_smoke(arch)).lower() \
                .compile().as_text()
        full = analyze_hlo(hlo, 4, dtype_correction=False)
        dots = DotWalker(parse_module(hlo), 4, False).computation_cost(
            "__entry__")
        res[arch + "|" + name] = {
            "matmul_flops": dots.flops, "flops": full["flops_per_device"],
            "bytes_fused": full["bytes_fused_per_device"],
            "collective_bytes": full["collective_bytes"]}
json.dump(res, open(out, "w"))
'''


def _port_main(shapes, archs, out):
    from repro_torch.analysis.op_cost import analyze_trace
    from repro_torch.configs import ShapeSpec, get_smoke
    from repro_torch.launch.mesh import init_fake, make_mesh
    from repro_torch.launch.specs import build_cell
    init_fake(4)
    mesh = make_mesh((2, 2), ("data", "model"))
    res = {}
    for arch in archs:
        for name, (s, b, kind) in shapes.items():
            tr = build_cell(arch, ShapeSpec(name, s, b, kind), mesh,
                            cfg=get_smoke(arch)).lower()
            c = analyze_trace(tr, 4)
            res[f"{arch}|{name}"] = {
                "matmul_flops": c["matmul_flops_per_device"],
                "flops": c["flops_per_device"],
                "bytes_fused": c["bytes_fused_per_device"],
                "collective_bytes": c["collective_bytes"]}
    with open(out, "w") as f:
        json.dump(res, f)


def _env(**extra):
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu", **extra)


@pytest.fixture(scope="module")
def costs(tmp_path_factory):
    pytest.importorskip("jax")
    out = tmp_path_factory.mktemp("cost")
    args = [json.dumps(SHAPES), json.dumps(ARCHS)]
    procs = {
        "ref": subprocess.Popen([sys.executable, "-c", _REFERENCE, *args,
                                 str(out / "ref.json")], env=_env(),
                                cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True),
        "port": subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                  *args, str(out / "port.json")],
                                 env=_env(), cwd=ROOT,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=TIMEOUT)
        assert proc.returncode == 0, f"{name}: {err[-4000:]}"
    return {name: json.loads((out / f"{name}.json").read_text())
            for name in procs}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_matmul_flops_equal_reference(costs, arch, shape):
    ref, port = costs["ref"][f"{arch}|{shape}"], \
        costs["port"][f"{arch}|{shape}"]
    ratio = port["matmul_flops"] / ref["matmul_flops"]
    print(f"{arch} {shape}: matmul flops port/ref {ratio:.4f}, flops "
          f"{port['flops']:.4e} / {ref['flops']:.4e}, bytes_fused "
          f"{port['bytes_fused']:.4e} / {ref['bytes_fused']:.4e}, "
          f"collectives {port['collective_bytes']} / "
          f"{ref['collective_bytes']}")
    assert port["matmul_flops"] > 0 and ref["matmul_flops"] > 0
    if (arch, shape) not in PARTITIONED_OTHERWISE:
        assert abs(ratio - 1) <= TOL, (arch, shape, ratio)


if __name__ == "__main__":
    _port_main(json.loads(sys.argv[1]), json.loads(sys.argv[2]), sys.argv[3])
