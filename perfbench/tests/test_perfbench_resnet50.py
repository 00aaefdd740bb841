"""The cell ``resnet50.offline`` on the CPU, small: the configuration's
topology at 3×96×96 with every width an eighth of the published (every
stage, the 7×7/s2 stem, the overlapping max pool over several SRAM chunks,
the 1×1/s2 projections, and a 3×3 = 9-position GAP after the last join),
compiled by ``programs/resnet50.py`` and served through
``NetworkProgram.serve`` on the CPU, equal to ``reference/resnet50.py``
bit for bit; the int4 control is not; the configuration's layers are the
model's at full size; the two epilogue metrics read a trace."""

import copy
import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import check, manifest, seeds, traffic  # noqa: E402

SEED = 2 ** 33 + 4321
CELL = "resnet50.offline"


def small_config(config: dict) -> dict:
    """``config`` at 3×96×96 with its widths an eighth, its layers the
    model's for that shape."""
    from repro_torch.models import resnet50
    small = copy.deepcopy(config)
    arch = small["architecture"]
    arch["stem_width"] //= 8
    arch["widths"] = [w // 8 for w in arch["widths"]]
    small["input"]["shape"] = [3, 96, 96]
    program = manifest.load_module(ROOT / "perfbench" / "programs"
                                   / "resnet50.py")
    small["layers"] = resnet50.layers(program.shape_of(small))
    return small


@pytest.fixture(scope="module")
def built():
    cell = manifest.load_cell(CELL, ROOT)
    cfg = small_config(cell.config)
    weights = seeds.weights(cfg, SEED)
    calib = traffic.calibration_images(cfg, SEED)
    net = cell.program().compile(cfg, weights, calib)
    ref = cell.reference()
    return cell, cfg, weights, calib, net, ref, ref.calibrate(cfg, weights,
                                                              calib)


def test_the_configuration_is_the_published_model():
    from repro_torch.models import resnet50
    cell = manifest.load_cell(CELL, ROOT)
    cfg = cell.config
    program = cell.program()
    assert resnet50.layers(program.shape_of(cfg)) == cfg["layers"]
    weights = sum(np.prod(s) for n, s in resnet50.weight_shapes(
        program.shape_of(cfg)).items() if n.endswith("_w"))
    assert weights == 25_502_912 and cfg["reduced"] == []
    assert [l["name"] for l in cfg["layers"] if "alu" in l][0] == "stem"
    assert sum(l["kind"] == "conv" for l in cfg["layers"]) == 53


def test_small_stem_spans_chunks(built):
    net = built[4]
    stem = net.layers[0]
    assert stem.spec.pool == "max3x3s2" and stem.n_chunks > 1
    assert net.layers[-2].program.alu_kind == "join+gap"


def test_reference_plans_the_compiler_shifts(built):
    _, cfg, _, _, net, _, plan = built
    shifts, pre = plan["shifts"], plan["pre_shifts"]
    got = {l.spec.name: l for l in net.layers}
    assert got["stem"].requant_shift == shifts["stem_q"]
    for name, layer in got.items():
        if name != "fc" and name.endswith("c"):
            block = name[:-1]
            pa, pb = pre[block + "_join"]
            assert layer.requant_shift == shifts[name + "_q"] + pa
            assert layer.spec.residual_pre_shift == pb
            after = "head_q" if layer.spec.pool == "gap" else block + "_q"
            assert layer.spec.residual_shift == shifts[after]
        elif name != "stem":
            assert layer.requant_shift == shifts[name + "_q"]
    assert shifts["head_q"] >= 3                 # floor(log2 9)


def test_reference_equals_the_port_bit_for_bit(built):
    cell, cfg, weights, _, net, ref, plan = built
    images = traffic.pool(cfg, cell.traffic, SEED, images_per_call=4)[0]
    got, _ = net.serve(images, device="cpu")
    want = ref.forward(cfg, weights, plan, images, "cpu", block=3)
    assert want.dtype == np.int8 and want.shape == (4, 1000)
    np.testing.assert_array_equal(got.reshape(4, -1), want)
    assert np.abs(want.astype(int)).max() > 0


def test_lower_precision_control_fails(built):
    cell, cfg, weights, _, _, ref, plan = built
    images = traffic.pool(cfg, cell.traffic, SEED, images_per_call=4)[0]
    want = ref.forward(cfg, weights, plan, images, "cpu")
    low = ref.forward(cfg, weights, plan, images, "cpu", bits=4)
    numbers = check.compare([(0, low)], [want])
    correct, _ = check.judge(numbers, cell.workload["limits"])
    assert not correct
    assert numbers["mismatched_logits"] > 0.5 * want.size


def _record(device, config, batch=256, calls=2):
    return {"config": config, "batch": batch, "device": {"kind": "NVIDIA H100"},
            "trace": {"spans": [(0.0, 1e6)], "device": device,
                      "calls": calls, "images": calls * batch}}


def test_epilogue_metrics_read_the_vta_alu_kernels():
    cell = manifest.load_cell(CELL, ROOT)
    readers = cell.metric_readers()
    device = [("vta_alu_image<4, false>", 0.0, 3000.0, "x"),
              ("vta_alu_stream<4>", 4000.0, 5000.0, "x"),
              ("vta_gemm_kernel", 5000.0, 9000.0, "x")]
    rec = _record(device, cell.config)
    ms = readers["vta_alu_device_ms_per_kimg"].read(rec)
    assert ms == pytest.approx(4.0 / 0.512)
    roof = manifest.load_module(ROOT / "perfbench" / "metrics"
                                / "vta_alu_roofline.py")
    nbytes = roof.epilogue_bytes(cell.config, 256)
    # the stem's 112·112·64 result at 5 bytes and 16 joins' at 9
    assert nbytes > 256 * 112 * 112 * 64 * 5
    share = readers["vta_alu_roofline"].read(rec)
    assert share == pytest.approx(100 * nbytes / 3.35e12 * 2 / 4e-3)
    assert readers["vta_alu_roofline"].read(_record(device[2:],
                                                    cell.config)) is None
    assert readers["vta_alu_device_ms_per_kimg"].read(
        _record(device[2:], cell.config)) is None
