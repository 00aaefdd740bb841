"""The plain reference against the port on the CPU: the same shifts from
the same calibration images, and the same logits, bit for bit, as
``NetworkProgram.serve`` on 4 seeded images of each configuration."""

import pathlib
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench.lib import manifest, seeds, traffic  # noqa: E402

SEED = 2 ** 31 + 12345


@pytest.fixture(scope="module", params=["resnet8.offline", "lenet5.offline"])
def built(request):
    cell = manifest.load_cell(request.param, ROOT)
    cfg = cell.config
    weights = seeds.weights(cfg, SEED)
    calib = traffic.calibration_images(cfg, SEED)
    net = cell.program().compile(cfg, weights, calib)
    ref = cell.reference()
    return cell, weights, calib, net, ref, ref.calibrate(cfg, weights, calib)


def test_reference_plans_the_compiler_shifts(built):
    cell, _, _, net, _, plan = built
    shifts = plan["shifts"]
    if cell.config["name"] == "lenet5":
        assert [l.requant_shift for l in net.layers] == list(shifts.values())
        return
    # resnet8: a layer's shift is its requant's, less the pool's ÷64 at the
    # head, plus the branch's pre-shift at a join
    got = {l.spec.name: l.requant_shift for l in net.layers}
    assert got["stem"] == shifts["stem_q"]
    assert got["head"] == shifts["head_q"] - 6
    for block in ("b1", "t2", "t3"):
        pa, pb = plan["pre_shifts"][block + "_join"]
        layer = next(l for l in net.layers if l.spec.name == block + "b")
        assert layer.requant_shift == shifts[block + "b_q"] + pa
        assert layer.spec.residual_pre_shift == pb
        assert layer.spec.residual_shift == shifts[block + "_q"]


def test_reference_equals_the_port_bit_for_bit(built):
    cell, weights, _, net, ref, plan = built
    images = traffic.pool(cell.config, cell.traffic, SEED,
                          images_per_call=4)[0]
    got, _ = net.serve(images, device="cpu")
    want = ref.forward(cell.config, weights, plan, images, "cpu", block=3)
    assert want.dtype == np.int8 and want.shape == (4, 10)
    np.testing.assert_array_equal(got.reshape(4, -1), want)
    assert np.abs(want.astype(int)).max() > 0


def test_seeded_inputs_repeat_and_differ():
    cfg = manifest.load_cell("lenet5.offline", ROOT).config
    a, b = seeds.weights(cfg, SEED), seeds.weights(cfg, SEED)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    c = seeds.weights(cfg, SEED + 1)
    assert not np.array_equal(a["conv2_w"], c["conv2_w"])
    assert a["conv1_w"].dtype == np.int8 and a["conv1_b"].dtype == np.int32
    imgs = traffic.calibration_images(cfg, -5)
    assert imgs.shape == (9, 1, 32, 32) and imgs.min() >= 0
