"""``vta_gemm.plan`` — the kernel's geometry — and the K split it implies.

``plan`` runs on the host, so its choices are checked here at the shapes
the kernel serves: LeNet-5's five GEMMs, resnet8's eleven, the CIFAR
CNN's five and resnet_tiny's seven at batch 32, and
``chip_smoke.KERNEL_GRID``.  ``ref.vta_gemm_split_ref`` sums each
plan's K slices as the kernel does (each warp group's slices in wrapping
int32, the groups added in order); it must equal ``ref.vta_gemm_ref`` and
the JAX package's ``vta_matmul_pallas`` (interpret mode).  The kernel
itself runs only on a card (``tests/test_torch_card.py``).
"""

import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ops as jops                            # noqa: E402
from repro.kernels import ref as jref                            # noqa: E402
from repro_torch.kernels import ref as tref                      # noqa: E402
from repro_torch.kernels import vta_gemm as vg                   # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_SMOKE = _chip_smoke()
LENET5 = [("l1_conv", 25088, 32, 16, "int32"),
          ("l2_conv", 3584, 160, 16, "int32"),
          ("l3_conv", 32, 400, 128, "int8"), ("l4_fc", 32, 128, 96, "int8"),
          ("l5_fc", 32, 96, 16, "int8")]
CNN_GEMMS = (_SMOKE.RESNET8_GEMMS + _SMOKE.CIFAR_CNN_GEMMS
             + _SMOKE.RESNET_TINY_GEMMS)
# the CIFAR CNN's c2 (K = 576 at 128-row tiles) fills the ring budget
# before it holds all of K; every other shape with K <= 576 holds it all
RING_BOUND_SHAPES = {(m, k, n, out) for name, m, k, n, out in
                     _SMOKE.CIFAR_CNN_GEMMS if name == "c2_conv"}
SHAPES = ([(m, k, n, out) for _, m, k, n, out in LENET5 + CNN_GEMMS]
          + [(m, k, n, "int8") for m, k, n in _SMOKE.KERNEL_GRID]
          + [(32, _SMOKE.WRAP_K, 16, "int32")])
_DTYPE = {"int8": torch.int8, "int32": torch.int32}


@pytest.mark.parametrize("sm_count", [132, 114])
@pytest.mark.parametrize("m,k,n,out", SHAPES)
def test_plan_geometry(m, k, n, out, sm_count):
    p = vg.plan(m, k, n, out_dtype=_DTYPE[out], sm_count=sm_count)
    assert (p.bm, p.bn, p.k_split, p.load) in vg.INSTANTIATIONS
    gx, gy = p.grid
    assert gx * p.bm >= m > (gx - 1) * p.bm          # tiles cover M once
    assert gy * p.bn >= n > (gy - 1) * p.bn          # and N
    assert gx < 2 ** 31 and gy <= vg.GRID_Y_LIMIT
    covered = sorted(r for warp in p.k_slices() for r in warp)
    assert [lo for lo, _ in covered] == list(range(0, k, vg.KSTEP))
    assert all(hi == min(k, lo + vg.KSTEP) for lo, hi in covered)
    assert p.smem_bytes <= vg.SMEM_LIMIT
    assert 1 <= p.stages <= vg.MAX_STAGES
    assert p.bk % (vg.KSTEP * p.k_split) == 0
    assert p.warps == p.bm // 16 * p.k_split <= vg.WARPS
    assert p.load == ("vec16" if k % 16 == 0 and n % 16 == 0 else "bytes")
    # K is split up to 8 warps a block, each group keeping two 32-byte K
    # steps where the grid is full, one under the 16 x 16 fallback
    full = p.blocks >= -(-3 * sm_count // 4)
    steps = -(-k // vg.KSTEP) // (2 if full else 1)
    assert p.warps == vg.WARPS or p.k_split == 2 ** (
        max(1, steps).bit_length() - 1)
    assert p.k_split == 1 or p.k_split <= steps
    if not full:                         # a smaller grid only from 16 x 16
        assert (p.bm, p.bn) == (16, 16)
    # the ring: as many stages as K needs, within MAX_STAGES and the budget
    assert p.stages == max(1, min(-(-k // p.bk), vg.MAX_STAGES,
                                  vg.RING_BUDGET // p.stage_bytes))
    if k <= 576 and (m, k, n, out) not in RING_BOUND_SHAPES:
        assert p.stages * p.bk >= k      # all K in flight


@pytest.mark.parametrize("m,k,n", [(25088, 32, 16), (1, 17, 5),
                                   (100, 300, 200)])
def test_plan_unaligned_operands_take_the_bytes_path(m, k, n):
    assert vg.plan(m, k, n, aligned=False).load == "bytes"


def test_plan_rule_at_lenet5_and_resnet8_shapes():
    """The rule as written in ``plan``'s docstring, at batch 32 on 132
    SMs: the largest tile whose grid holds 99 blocks, else 16 x 16, and up
    to 8 warps a block where K has the steps for them."""
    got = [(p.bm, p.bn, p.k_split, p.blocks) for p in
           (vg.plan(m, k, n, out_dtype=_DTYPE[out])
            for _, m, k, n, out in LENET5 + _SMOKE.RESNET8_GEMMS)]
    assert got == [(128, 16, 1, 196), (32, 16, 2, 112), (16, 16, 8, 16),
                   (16, 16, 4, 12), (16, 16, 2, 2),                # LeNet-5
                   (128, 16, 1, 256), (128, 16, 1, 256), (128, 16, 1, 256),
                   (128, 16, 1, 128), (128, 16, 1, 128), (128, 16, 1, 128),
                   (64, 16, 2, 128), (64, 16, 2, 128), (64, 16, 2, 128),
                   (64, 16, 1, 128), (16, 16, 2, 2)]               # resnet8


def test_plan_takes_wide_tiles_where_the_grid_allows():
    assert (vg.plan(4096, 256, 512).bm, vg.plan(4096, 256, 512).bn) == (
        128, 64)
    assert vg.plan(1, 17, 5).k_split == 1                 # one K step


def test_plan_refuses_a_grid_too_wide():
    with pytest.raises(ValueError, match="grid limit"):
        vg.plan(16, 32, 64 * (vg.GRID_Y_LIMIT + 1))


def test_instantiations_match_the_source():
    """``GEOMETRIES`` is the table ``csrc/vta_gemm.cu`` instantiates, each
    on both load paths; ``plan`` never leaves it (test_plan_geometry)."""
    text = vg.SOURCE.read_text()
    table = text[text.index("#define VTA_GEMM_GEOMETRIES"):]
    table = table[:table.index("\n\n")]
    found = [tuple(int(x) for x in t)
             for t in re.findall(r"X\((\d+), (\d+), (\d+)\)", table)]
    assert found == list(vg.GEOMETRIES)
    assert len(vg.INSTANTIATIONS) == 2 * len(found)


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(-128, 128, (m, k)).astype(np.int8),
            rng.integers(-128, 128, (k, n)).astype(np.int8),
            rng.integers(-(2 ** 20), 2 ** 20, (n,)).astype(np.int32))


@pytest.mark.parametrize("m,k,n", [(32, 400, 128), (32, 128, 96),
                                   (32, 96, 16), (8, 128, 128),
                                   (100, 300, 200), (1, 17, 5),
                                   (130, 200, 140), (32, 64, 16)])
def test_split_sum_matches_reference_and_pallas(m, k, n):
    a, b, bias = _operands(m, k, n, m + k + n)
    p = vg.plan(m, k, n)
    for kw in (dict(relu=True, shift=3, saturate=False),
               dict(saturate=True), dict(out_dtype=jnp.int32)):
        tkw = {key: _DTYPE[str(np.dtype(v))] if key == "out_dtype" else v
               for key, v in kw.items()}
        got = tref.vta_gemm_split_ref(torch.from_numpy(a), torch.from_numpy(b),
                                      torch.from_numpy(bias), p, **tkw)
        want = tref.vta_gemm_ref(torch.from_numpy(a), torch.from_numpy(b),
                                 torch.from_numpy(bias), **tkw)
        assert torch.equal(got, want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jops.vta_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                                   jnp.asarray(bias), **kw)))
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jref.vta_gemm_ref(jnp.asarray(a), jnp.asarray(b),
                              jnp.asarray(bias), **kw)))


@pytest.mark.parametrize("out_dtype", [jnp.int32, jnp.int8])
def test_split_sum_wraps_with_bias(out_dtype):
    """A·B + bias crosses 2**31 upward and downward (the existing wrap
    case) under a plan that splits K over 8 warps."""
    a = np.full((40, 256), 127, np.int8)
    b = np.full((256, 24), 127, np.int8)
    b[:, 12:] = -127
    bias = np.array([2 ** 31 - 1000] * 12 + [-(2 ** 31) + 7] * 12, np.int32)
    p = vg.plan(40, 256, 24)
    assert p.k_split == 8 and p.bm == 16
    got = tref.vta_gemm_split_ref(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(bias), p,
        out_dtype=_DTYPE[str(np.dtype(out_dtype))], saturate=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.vta_matmul_pallas(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(bias), out_dtype=out_dtype,
                               saturate=False)))


@pytest.mark.parametrize("k_split", [8, 1])
@pytest.mark.parametrize("out_dtype", [torch.int32, torch.int8])
def test_split_sum_wraps_past_two_to_the_31(k_split, out_dtype):
    """M = 32, K = 139,264, N = 16, A = B = -128: the sum of the K slices
    is 2,281,701,376 and wraps to -2,013,265,920, under the plan (8 warps)
    and with one warp summing all of K."""
    m, k, n = 32, _SMOKE.WRAP_K, 16
    a = torch.full((m, k), -128, dtype=torch.int8)
    b = torch.full((k, n), -128, dtype=torch.int8)
    p = (vg.plan(m, k, n) if k_split == 8
         else vg.make_plan(m, k, n, 16, 16, 1, "vec16"))
    assert p.k_split == k_split
    got = tref.vta_gemm_split_ref(a, b, None, p, out_dtype=out_dtype,
                                  saturate=False)
    assert torch.equal(got, tref.vta_gemm_ref(a, b, out_dtype=out_dtype,
                                              saturate=False))
    if out_dtype == torch.int32:
        assert int(got[0, 0]) == 128 * 128 * k - 2 ** 32 == -2_013_265_920


def test_resnet8_shapes_are_the_reference_compilers():
    """``chip_smoke.RESNET8_GEMMS`` is what the reference compiler gives
    for resnet8 through ``plan_pallas`` at batch 32: fused layers commit
    int8, the others hand int32 to the TensorAlu."""
    from repro.core.pallas_backend import plan_pallas
    from repro.models.resnet8 import compile_resnet8
    net, _ = compile_resnet8()
    got = []
    for layer in net.layers:
        p = plan_pallas(layer.program)
        mp, np_ = p.padded_shape
        got.append((layer.spec.name, 32 * mp, p.lam * p.block_size, np_,
                    "int8" if p.fused else "int32"))
    assert got == _SMOKE.RESNET8_GEMMS


def _reference_gemms(net):
    from repro.core.pallas_backend import plan_pallas
    got = []
    for layer in net.layers:
        p = plan_pallas(layer.program)
        mp, np_ = p.padded_shape
        got.append((layer.spec.name, 32 * mp, p.lam * p.block_size, np_,
                    "int8" if p.fused else "int32"))
    return got


def test_cifar_cnn_and_resnet_tiny_shapes_are_the_reference_compilers():
    """``chip_smoke.CIFAR_CNN_GEMMS`` and ``RESNET_TINY_GEMMS`` are what
    the reference compiler gives through ``plan_pallas`` at batch 32 (the
    CIFAR CNN compiled as ``examples/cifar10_cnn_e2e.py`` does): K = 80
    (75 padded) at M = 1024 rows an image, K = 1024 and 2048 fc layers."""
    from repro.core.network_compiler import compile_network
    from repro.models import cifar_cnn
    from repro.models.resnet_tiny import compile_resnet_tiny
    w = cifar_cnn.cifar_cnn_random_weights(seed=0)
    shifts = cifar_cnn.calibrate_shifts(
        w, [cifar_cnn.synthetic_cifar_image(s) for s in range(1, 9)])
    net = compile_network(cifar_cnn.cifar_cnn_specs(w, shifts),
                          cifar_cnn.synthetic_cifar_image(0))
    assert _reference_gemms(net) == _SMOKE.CIFAR_CNN_GEMMS
    assert _reference_gemms(compile_resnet_tiny()[0]) == \
        _SMOKE.RESNET_TINY_GEMMS


def test_lenet5_shapes_are_the_ports():
    """``LENET5`` is what the port's compiler gives for LeNet-5 at batch
    32 (the shapes ``chip_smoke.py`` phase 5 times)."""
    from repro_torch.core.cuda_backend import plan_cuda
    from repro_torch.lenet5_e2e import compile_lenet5
    _, net = compile_lenet5()
    got = []
    for layer in net.layers:
        p = plan_cuda(layer.program)
        mp, np_ = p.padded_shape
        got.append((layer.spec.name, 32 * mp, p.lam * p.block_size, np_,
                    "int8" if p.fused else "int32"))
    assert got == LENET5
