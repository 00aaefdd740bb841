"""The port's hand-written kernels against their plain versions, on a card.

Every test here is marked ``cuda``: it decides inside the test whether a
CUDA card is present and skips on a host without one.  The module imports
no ``jax``, so it runs on the card's machine:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_card.py

``chip_smoke.py`` runs the full grids and the main paths.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref                        # noqa: E402


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [(torch.float32, 2e-5, 2e-5),
                                             (torch.bfloat16, 4e-3, 2 ** -7)])
@pytest.mark.parametrize("shape,kw", [
    ((2, 4, 2, 70, 90, 64), dict(causal=False)),
    ((1, 4, 1, 33, 130, 256), dict(causal=True, q_offset=97)),
    ((1, 2, 2, 64, 64, 16), dict(causal=True, window=9)),
    ((4, 8, 2, 1, 77, 128), dict(causal=True, q_offset=76)),
    ((1, 2, 2, 10, 10, 32), dict(causal=True, q_offset=-5)),
    # nemotron-4-340b's head set (96 query heads over 8, D = 192)
    ((1, 96, 8, 40, 70, 192), dict(causal=True, q_offset=30)),
    ((2, 96, 8, 1, 300, 192), dict(causal=True, q_offset=299)),
    # gemma3-1b's local layers (D = 256, window 512): prefill, and the
    # decode over its wrapped ring (non-causal over every slot)
    ((1, 4, 1, 600, 600, 256), dict(causal=True, window=512)),
    ((2, 4, 1, 1, 512, 256), dict(causal=False)),
    # whisper-base's 1,500 encoder frames, a ragged last KV tile: the
    # encoder and the cross-attention decode, non-causal
    ((1, 2, 2, 1500, 1500, 64), dict(causal=False)),
    ((4, 2, 2, 1, 1500, 64), dict(causal=False)),
    # GQA group 6 (internvl2-26b's 48 heads over 8), prefill and decode
    ((1, 12, 2, 300, 300, 128), dict(causal=True)),
    ((2, 12, 2, 1, 1280, 128), dict(causal=True, q_offset=1000)),
])
def test_flash_attention_matches_plain(shape, kw, dtype, atol, rtol):
    """bf16: one ulp relative plus 4e-3 near 0, and at most 5 % of the
    values differ from the plain version's (both round to nearest)."""
    dev = _card()
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(sq + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(dev, dtype) for s in ((b, h, sq, d), (b, hkv, skv, d),
                                         (b, hkv, skv, d)))
    from repro_torch.kernels import flash_attention as fa
    launches = fa.plan(*shape, dtype, **kw,             # 2 after a split
                       sm_count=fa.device_sm_count(dev)).launches
    before = ops.attention_launches
    got = ops.attention(q, k, v, **kw)
    assert ops.attention_launches == before + launches
    want = ref.attention_ref(q, k, v, **kw)
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
    if dtype == torch.bfloat16:
        assert float((got != want).float().mean()) <= 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw", [
    ((2, 16, 2, 300, 300, 128), dict(causal=True)),      # unsplit tiles
    ((4, 16, 2, 1, 1280, 128), dict(causal=True, q_offset=1000)),  # decode
    ((1, 16, 2, 256, 2048, 128), dict(causal=True, q_offset=1792)),  # split
    ((1, 2, 2, 10, 10, 32), dict(causal=True, q_offset=-5)),  # empty rows
    ((2, 8, 8, 1, 160, 128), dict(causal=True, q_offset=-40)),  # no key
    ((2, 12, 2, 1, 1280, 128), dict(causal=True, q_offset=1000)),  # group 6
])
def test_flash_attention_lse_matches_plain(shape, kw, dtype):
    """``return_lse`` against ``ref.attention_lse_ref``: o (float32 in this
    mode) rounded to the inputs' dtype at the attention gates and equal to
    the call without lse; lse within 1e-5 × max(1, |lse|), -inf exactly
    where a row keeps no key; the launches of the call without lse.  Then
    the decode shapes' slots cut into 4 ranges, each range's pair
    combined by ``serving.engine.combine_partials`` with a local
    reduction: the whole call at the same gates."""
    dev = _card()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.serving.engine import combine_partials
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
               .to(dev, dtype) for s in ((b, h, sq, d), (b, hkv, skv, d),
                                         (b, hkv, skv, d)))
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (4e-3, 2 ** -7)

    def close(got, want):
        torch.testing.assert_close(got, want, atol=atol, rtol=rtol)
        if dtype == torch.bfloat16:
            assert float((got != want).float().mean()) <= 0.05

    launches = fa.plan(*shape, dtype, **kw,
                       sm_count=fa.device_sm_count(dev)).launches
    before = ops.attention_launches
    got, lse = ops.attention(q, k, v, **kw, return_lse=True)
    assert ops.attention_launches == before + launches
    assert got.dtype == lse.dtype == torch.float32
    want, want_lse = ref.attention_lse_ref(q, k, v, **kw)
    close(got.to(dtype), want.to(dtype))
    whole = ops.attention(q, k, v, **kw)
    assert torch.equal(got.to(dtype), whole)
    empty = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), empty)
    assert bool((lse[empty] < 0).all()) and bool((got[empty] == 0).all())
    assert bool(((lse - want_lse).abs()[~empty]
                 <= 1e-5 * want_lse.abs().clamp(min=1.0)[~empty]).all())
    if sq != 1 or kw["q_offset"] < 0:
        return
    n = skv // 4
    parts = [ops.attention(q, k[:, :, i * n:(i + 1) * n].contiguous(),
                           v[:, :, i * n:(i + 1) * n].contiguous(),
                           causal=True, q_offset=kw["q_offset"] - i * n,
                           return_lse=True) for i in range(4)]
    o = combine_partials(torch.stack([x[0] for x in parts]),
                         torch.stack([x[1] for x in parts]),
                         lambda t: t.amax(0, keepdim=True),
                         lambda t: t.sum(0, keepdim=True))[0]
    close(o.to(dtype), whole)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(8, 128, 128), (100, 300, 200),
                                   (1, 17, 5)])
def test_vta_gemm_matches_plain(m, k, n):
    dev = _card()
    rng = np.random.default_rng(m + k + n)
    a = torch.from_numpy(rng.integers(-128, 128, (m, k)).astype(np.int8))
    b = torch.from_numpy(rng.integers(-128, 128, (k, n)).astype(np.int8))
    bias = torch.from_numpy(rng.integers(-5000, 5000, (n,)).astype(np.int32))
    a, b, bias = a.to(dev), b.to(dev), bias.to(dev)
    for kw in (dict(relu=True, shift=3), dict(out_dtype=torch.int32)):
        assert torch.equal(ops.vta_matmul(a, b, bias, **kw),
                           ref.vta_gemm_ref(a, b, bias, **kw))


def _int8(rng, shape, dev, lo=-128, hi=128):
    return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int8)).to(
        dev)


# One case per plan class: tile rows 16/32/64/128, K split 1 or more (up to
# 8 warps a block), vec16 or bytes; (bm, bn, k_split, load).
PLAN_CLASSES = [(bm, bn, ks, load)
                for load in ("vec16", "bytes")
                for bm, bn, ks in ((16, 64, 1), (16, 16, 8), (32, 32, 1),
                                   (32, 16, 4), (64, 16, 1), (64, 64, 2),
                                   (128, 64, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("bm,bn,k_split,load", PLAN_CLASSES)
def test_vta_gemm_plan_classes_match_plain(bm, bn, k_split, load):
    """Each plan class, forced at a shape with ragged M (and, on the bytes
    path, ragged K and N), against the plain version, exact."""
    from repro_torch.kernels import vta_gemm as vg
    dev = _card()
    m, n = 2 * bm + 3, 2 * bn - (5 if load == "bytes" else 0)
    k = 3 * 32 * k_split + (7 if load == "bytes" else 16)
    rng = np.random.default_rng(bm + bn + k_split)
    a, b = _int8(rng, (m, k), dev), _int8(rng, (k, n), dev)
    bias = torch.from_numpy(rng.integers(-5000, 5000, (n,)).astype(
        np.int32)).to(dev)
    plan = vg.make_plan(m, k, n, bm, bn, k_split, load)
    assert (bm, bn, k_split, load) in vg.INSTANTIATIONS
    for kw in (dict(relu=True, shift=3, saturate=False),
               dict(out_dtype=torch.int32)):
        out = torch.empty((m, n), dtype=kw.get("out_dtype", torch.int8),
                          device=dev)
        vg._launch(a, b, bias, out, plan,
                   **{key: v for key, v in kw.items() if key != "out_dtype"})
        torch.cuda.synchronize()
        assert torch.equal(out, ref.vta_gemm_ref(a, b, bias, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("k_split", [None, 1])
def test_vta_gemm_accumulator_wraps(k_split):
    """M = 32, K = 139,264, N = 16, A = B = -128: A·B is 2,281,701,376,
    which wraps to -2,013,265,920 in int32.  Through the public wrapper
    (its plan splits K over 8 warps, whose partials meet in uint32) and
    with one warp summing all of K in the mma accumulator."""
    from repro_torch.kernels import vta_gemm as vg
    dev = _card()
    m, k, n = 32, 139_264, 16
    a = torch.full((m, k), -128, dtype=torch.int8, device=dev)
    b = torch.full((k, n), -128, dtype=torch.int8, device=dev)
    for kw in (dict(out_dtype=torch.int32),
               dict(out_dtype=torch.int8, saturate=False)):
        want = ref.vta_gemm_ref(a, b, **kw)
        if k_split is None:
            got = ops.vta_matmul(a, b, **kw)
        else:
            got = torch.empty((m, n), dtype=kw["out_dtype"], device=dev)
            vg._launch(a, b, None, got,
                       vg.make_plan(m, k, n, 16, 16, k_split, "vec16"),
                       saturate=kw.get("saturate", True))
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert int(ref.vta_gemm_ref(a, b, out_dtype=torch.int32)[0, 0]) == (
        -2_013_265_920)


@pytest.mark.cuda
@pytest.mark.parametrize("change", [dict(bm=48), dict(bm=32, k_split=8),
                                    dict(bk=96), dict(stages=9),
                                    dict(bn=128)])
def test_vta_gemm_plan_without_instantiation_is_refused(change):
    """A geometry the library has no instantiation for, or one that does
    not fit the shape, is refused before any launch."""
    import dataclasses
    from repro_torch.kernels import vta_gemm as vg
    dev = _card()
    m, k, n = 64, 256, 64
    rng = np.random.default_rng(9)
    a, b = _int8(rng, (m, k), dev), _int8(rng, (k, n), dev)
    plan = dataclasses.replace(vg.plan(m, k, n), **change)
    with pytest.raises(vg.KernelLaunchError, match="cudaError 1 "):
        vg._launch(a, b, None, torch.empty((m, n), dtype=torch.int8,
                                           device=dev), plan)


def _attention_inputs(shape, dtype, dev, seed):
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, dtype=np.float32))
                 .to(dev, dtype) for s in ((b, h, sq, d), (b, hkv, skv, d),
                                           (b, hkv, skv, d)))


def _check_bf16(got, want):
    torch.testing.assert_close(got, want, atol=4e-3, rtol=2 ** -7)
    assert float((got != want).float().mean()) <= 0.05


# (b, h, hkv, sq, skv, d), kwargs, path: both bf16 paths at every head dim,
# ragged lengths, the split threshold (group x Sq = 16 and 24), a window of
# 9, q_offset -5 (rows with no key) and non-causal at a ragged Skv.
BF16_PATH_CASES = [
    *[((1, 4, 2, 200, 333, d), dict(causal=True, q_offset=133), "bf16_tiles")
      for d in (16, 32, 64, 128, 192, 256)],
    *[((2, 8, 2, 3, 1000, d), dict(causal=True, q_offset=997), "bf16_split")
      for d in (16, 32, 64, 128, 192, 256)],
    ((1, 8, 1, 2, 517, 128), dict(causal=True, q_offset=515), "bf16_split"),
    ((1, 8, 1, 3, 517, 128), dict(causal=True, q_offset=514), "bf16_tiles"),
    ((1, 4, 2, 130, 130, 64), dict(causal=True, window=9), "bf16_tiles"),
    ((2, 4, 4, 1, 300, 64), dict(causal=True, window=9, q_offset=299),
     "bf16_split"),
    ((1, 2, 1, 10, 10, 32), dict(causal=True, q_offset=-5), "bf16_tiles"),
    ((1, 8, 2, 4, 10, 32), dict(causal=True, q_offset=-2), "bf16_split"),
    ((1, 4, 2, 70, 91, 128), dict(causal=False), "bf16_tiles"),
    ((1, 4, 4, 3, 91, 256), dict(causal=False), "bf16_split"),
    ((1, 2, 1, 300, 2000, 128), dict(causal=True, q_offset=1700),
     "bf16_tiles"),                                     # splits the KV range
    # GQA group 6: 6 and 12 packed rows of a 16-row tile (decode, two
    # positions), 18 rows go to the tiles; jamba's group 8 at its shapes
    ((2, 12, 2, 1, 1280, 128), dict(causal=True, q_offset=1000),
     "bf16_split"),
    ((1, 6, 1, 2, 517, 128), dict(causal=True, q_offset=515), "bf16_split"),
    ((1, 6, 1, 3, 517, 128), dict(causal=True, q_offset=514), "bf16_tiles"),
    ((1, 12, 2, 1040, 1040, 128), dict(causal=True), "bf16_tiles"),
    ((1, 16, 2, 1, 1280, 128), dict(causal=True, q_offset=1023),
     "bf16_split"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw,path", BF16_PATH_CASES)
def test_bf16_paths_match_plain(shape, kw, path):
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    q, k, v = _attention_inputs(shape, torch.bfloat16, dev, sum(shape))
    plan = fa.plan(*shape, torch.bfloat16, **kw,
                   sm_count=fa.device_sm_count(dev))
    assert plan.path == path
    before = ops.attention_launches
    got = ops.attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.attention_launches == before + plan.launches
    _check_bf16(got, ref.attention_ref(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw", [
    ((2, 16, 2, 1, 1500, 128), dict(causal=True, q_offset=1499)),
    ((1, 4, 1, 3, 700, 64), dict(causal=True, window=200, q_offset=697)),
    ((2, 12, 2, 1, 1280, 128), dict(causal=True, q_offset=1279)),  # group 6
])
def test_split_partials_match_plain(shape, kw):
    """The split kernel's float32 partials (m, l, acc per split) against
    ``ref.attention_split_ref``'s, then the combined output."""
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    b, h, hkv, sq, skv, d = shape
    q, k, v = _attention_inputs(shape, torch.bfloat16, dev, 3)
    plan = fa.plan(*shape, torch.bfloat16, **kw,
                   sm_count=fa.device_sm_count(dev))
    assert plan.path == "bf16_split" and plan.splits > 1
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=dev)
    got = torch.empty_like(q)
    fa._launch(q, k, v, got, scratch, plan, **kw)
    torch.cuda.synchronize()
    want, m, l, acc = ref.attention_split_ref(
        q, k, v, splits=plan.splits, chunk=plan.chunk, partials=True, **kw)
    n_acc = plan.splits * b * h * sq * d
    got_acc = scratch[:n_acc].view(plan.splits, b, h, sq, d)
    got_ml = scratch[n_acc:].view(plan.splits, b, h, sq, 2)
    assert torch.equal(torch.isinf(got_ml[..., 0]), torch.isinf(m))
    live = ~torch.isinf(m)
    torch.testing.assert_close(got_ml[..., 0][live], m[live], atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(got_ml[..., 1], l, atol=1e-4, rtol=1e-3)
    torch.testing.assert_close(got_acc, acc, atol=1e-2, rtol=1e-3)
    _check_bf16(got, want)
    _check_bf16(got, ref.attention_ref(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("splits", [1, 2, 3])
def test_tiles_split_count_matches_plain(splits):
    """The tiles path at a KV split count other than the plan's (the
    comparison ``chip_smoke.py`` times) is right too, and each launch is
    counted as the library reports it."""
    import dataclasses
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    shape, kw = (1, 2, 1, 300, 2000, 128), dict(causal=True, q_offset=1700)
    q, k, v = _attention_inputs(shape, torch.bfloat16, dev, 5)
    plan = dataclasses.replace(fa.plan(*shape, torch.bfloat16, **kw),
                               splits=splits)
    scratch = (torch.empty(plan.scratch_floats, dtype=torch.float32,
                           device=dev) if plan.scratch_floats else None)
    got = torch.empty_like(q)
    before = fa.launches
    fa._launch(q, k, v, got, scratch, plan, **kw)
    torch.cuda.synchronize()
    assert fa.launches == before + plan.launches
    _check_bf16(got, ref.attention_ref(q, k, v, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,change", [
    (torch.float32, dict(block_kv=128)),
    (torch.float32, dict(block_q=128)),
    (torch.float32, dict(stages=3)),
    (torch.float32, dict(chunk=64)),
    (torch.bfloat16, dict(block_kv=64)),
    (torch.bfloat16, dict(stages=2)),
    (torch.bfloat16, dict(block_q=64)),
])
def test_plan_without_instantiation_is_refused(dtype, change):
    """A geometry the library was not built for is refused before any
    launch: nothing is counted and the call raises."""
    import dataclasses
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    shape, kw = (1, 4, 2, 200, 333, 128), dict(causal=True, q_offset=133)
    q, k, v = _attention_inputs(shape, dtype, dev, 6)
    plan = dataclasses.replace(fa.plan(*shape, dtype, **kw), **change)
    scratch = torch.empty(max(1, plan.scratch_floats), dtype=torch.float32,
                          device=dev)
    before = fa.launches
    with pytest.raises(fa.KernelLaunchError, match="cudaError 1 "):
        fa._launch(q, k, v, torch.empty_like(q), scratch, plan, **kw)
    assert fa.launches == before


def _f32_plan(shape, kw, dev, key, splits):
    """The f32 plan of ``shape`` on instantiation ``key`` (D, block_q,
    block_kv, stages) at ``splits`` KV splits."""
    import dataclasses
    from repro_torch.kernels import flash_attention as fa
    _, bq, bk, st = key
    return dataclasses.replace(
        fa.plan(*shape, torch.float32, **kw, sm_count=fa.device_sm_count(dev)),
        block_q=bq, block_kv=bk, stages=st, splits=splits)


F32_SHAPES = [
    ((2, 4, 2, 70, 130), dict(causal=True, q_offset=60)),
    ((1, 3, 1, 150, 301), dict(causal=False, window=40, q_offset=100)),
    ((1, 2, 2, 10, 10), dict(causal=True, q_offset=-5)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("key", [(16, 64, 64, 2), (32, 64, 64, 2),
                                 (64, 128, 64, 2), (128, 64, 32, 2),
                                 (192, 64, 16, 2), (256, 64, 16, 2)])
def test_f32_every_instantiation_matches_plain(key):
    """Each float32 instantiation (every head dim) at ragged lengths,
    causal with q_offset, a window, rows with no key, unsplit and split
    into 3 (the combine), within 2e-5; launches counted as reported."""
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    assert key in fa.F32_INSTANTIATIONS
    for dims, kw in F32_SHAPES:
        shape = (*dims, key[0])
        q, k, v = _attention_inputs(shape, torch.float32, dev, sum(shape))
        want = ref.attention_ref(q, k, v, **kw)
        for splits in (1, 3):
            plan = _f32_plan(shape, kw, dev, key, splits)
            scratch = torch.empty(max(1, plan.scratch_floats),
                                  dtype=torch.float32, device=dev)
            got = torch.empty_like(q)
            before = fa.launches
            fa._launch(q, k, v, got, scratch, plan, **kw)
            torch.cuda.synchronize()
            assert fa.launches == before + (1 if splits == 1 else 2)
            torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,kw,splits", [
    ((1, 4, 2, 70, 700, 64), dict(causal=False), None),
    ((1, 4, 2, 70, 700, 64), dict(causal=True, q_offset=699), 5),
    ((1, 2, 1, 33, 300, 128), dict(causal=False), 4),
])
def test_f32_split_partials_match_plain(shape, kw, splits):
    """The float32 kernel's partials (m, l, acc per split; every q tile
    keeps every key here, so a split is ``per`` whole KV tiles from key 0,
    and a split past the last tile keeps none) against
    ``ref.attention_split_ref``'s, then the combined output."""
    from repro_torch.kernels import flash_attention as fa
    dev = _card()
    b, h, hkv, sq, skv, d = shape
    q, k, v = _attention_inputs(shape, torch.float32, dev, 4)
    plan = fa.plan(*shape, torch.float32, **kw,
                   sm_count=fa.device_sm_count(dev))
    if splits is not None:
        plan = _f32_plan(shape, kw, dev, (d, plan.block_q, plan.block_kv,
                                          plan.stages), splits)
    per = -(-(-(-skv // plan.block_kv)) // plan.splits)     # tiles a split
    assert plan.splits > 1          # 5 splits of 3 tiles: the last is empty
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=dev)
    got = torch.empty_like(q)
    fa._launch(q, k, v, got, scratch, plan, **kw)
    torch.cuda.synchronize()
    want, m, l, acc = ref.attention_split_ref(
        q, k, v, splits=plan.splits, chunk=per * plan.block_kv,
        partials=True, **kw)
    n_acc = plan.splits * b * h * sq * d
    got_acc = scratch[:n_acc].view(plan.splits, b, h, sq, d)
    got_ml = scratch[n_acc:].view(plan.splits, b, h, sq, 2)
    assert torch.equal(torch.isinf(got_ml[..., 0]), torch.isinf(m))
    live = ~torch.isinf(m)
    torch.testing.assert_close(got_ml[..., 0][live], m[live], atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(got_ml[..., 1], l, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_acc, acc, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)
    torch.testing.assert_close(got, ref.attention_ref(q, k, v, **kw),
                               atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_engine_two_workers_match_direct_serve():
    """Two ``cuda`` workers drain one queue on the card: every answer equals
    a direct serve of the same image, the audit is clean, and ``vta_gemm``
    launches exactly 5 times (LeNet-5's layers) per executed batch."""
    dev = _card()
    from repro_torch.lenet5_e2e import compile_lenet5
    from repro_torch.serving import vta
    _, net = compile_lenet5()
    images = vta.request_images(net, 40, seed=3)
    engine = vta.VTAServingEngine(
        net, policy=vta.BatchPolicy(max_batch=8, max_wait_s=0.002),
        backends=("cuda", "cuda"), device=dev).start()   # warm-up serve
    ops.reset_launches()
    try:
        outs, tickets = vta.serve_all(engine, images)
    finally:
        engine.shutdown()
    launches = ops.launches
    direct, _ = net.serve(images, device=dev)
    np.testing.assert_array_equal(outs, direct)
    assert engine.metrics.audit() == [] and engine.metrics.drained()
    batches = {(t.record.worker, t.record.dispatch_t) for t in tickets}
    assert launches == 5 * len(batches)
    assert ops.attention_launches == 0


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["lenet5", "resnet_tiny"])
def test_interpreters_on_the_card_match_the_host(model):
    """The torch interpreters on the card: ``batched`` and ``fast`` serves
    equal the same serves on the host and the ``cuda`` backend's, with the
    overflow counters equal too, and launch no ``vta_gemm``."""
    dev = _card()
    if model == "lenet5":
        from repro_torch.lenet5_e2e import compile_lenet5, request_images
        net = compile_lenet5()[1]
        images = request_images(6)
    else:                                   # max-pool pair lattices
        from repro_torch.models import resnet_tiny
        net = resnet_tiny.compile_resnet_tiny()[0]
        images = np.stack([resnet_tiny.synthetic_image(s) for s in range(6)])
    want, _ = net.serve(images, device=dev)
    before = ops.launches
    got, reps = net.serve(images, backend="batched", device=dev,
                          count_overflows=True)
    host, host_reps = net.serve(images, backend="batched", device="cpu",
                                count_overflows=True)
    one = net.serve_one(images[0], backend="fast", device=dev)
    assert ops.launches == before
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(host, want)
    np.testing.assert_array_equal(one, want[0])
    assert ([(r.acc_overflow_lanes, r.acc_saturation_lanes) for r in reps]
            == [(r.acc_overflow_lanes, r.acc_saturation_lanes)
                for r in host_reps])


LM_SMOKE = ["lm100m", "qwen2.5-3b", "qwen1.5-110b", "nemotron-4-340b",
            "gemma3-1b", "internvl2-26b", "whisper-base", "mixtral-8x22b",
            "moonshot-v1-16b-a3b", "jamba-1.5-large-398b", "rwkv6-7b"]
# whisper-base smoke is ill-conditioned (the JAX package's own float32
# logits lie 1.3e-3 of max |logit| from float64): on the CPU its bf16 plain
# path lies 0.13 of max |logit| from the same path on ``ref.attention_ref``,
# which the kernel holds to one bf16 ulp; the other configs 0.005-0.024
BF16_TOL = {"whisper-base": 0.25}


def lm_planned_launches(fa, cfg, b: int, s: int, max_seq: int, steps: int,
                        dtype, cache_dtype, sms: int) -> int:
    """The attention launches of one prefill of ``s`` tokens (after the
    config's modality prefix) and ``steps`` decode steps, summed over the
    plans of every call at the padded head dim: a causal self-attention a
    layer in prefill (windowed on local/SWA layers), a decode over the
    dense cache or over the windowed ring (``ring_attention_args``' masks),
    and on an encoder-decoder the encoder twice (inside prefill, and once
    for the decode steps' ``enc_out``) and a cross-attention a layer and
    call."""
    from repro_torch.serving.engine import ring_attention_args
    d = fa.padded_head_dim(cfg.head_dim)
    heads = (b, cfg.n_heads, cfg.n_kv_heads)
    s_all = s + cfg.frontend_prefix
    n = 0
    if cfg.encoder_layers:
        t_enc = cfg.encoder_seq
        n += 2 * cfg.encoder_layers * fa.plan(
            *heads, t_enc, t_enc, d, dtype, causal=False,
            sm_count=sms).launches
        n += cfg.n_layers * (
            fa.plan(*heads, s_all, t_enc, d, dtype, causal=False,
                    sm_count=sms).launches
            + steps * fa.plan(*heads, 1, t_enc, d, dtype, causal=False,
                              sm_count=sms).launches)
    for kind in cfg.layer_schedule():
        if not kind.startswith("attn"):
            continue
        window = (cfg.local_window if kind in ("attn_local", "attn_swa")
                  else None)
        n += fa.plan(*heads, s_all, s_all, d, dtype, window=window,
                     sm_count=sms).launches
        slots = max_seq if window is None else min(window, max_seq)
        for t in range(steps):
            masks = (dict(q_offset=s_all + t) if window is None
                     else ring_attention_args(slots, s_all + t))
            n += fa.plan(*heads, 1, slots, d, cache_dtype, **masks,
                         sm_count=sms).launches
    return n


@pytest.mark.cuda
@pytest.mark.parametrize("dtype, cache_dtype, tol", [
    (torch.float32, torch.float32, 1e-4),
    # bf16 rounds the residual stream at every op (2^-8 relative) and the
    # kernel holds 4e-3 + 2^-7 a call: a 3-layer model stays within 5e-2
    (torch.bfloat16, torch.bfloat16, 5e-2),
    # bf16 weights over a float32 cache: decode casts q to the cache's
    # dtype for the kernel
    (torch.bfloat16, torch.float32, 5e-2)])
@pytest.mark.parametrize("arch", LM_SMOKE)
def test_lm_prefill_and_decode_kernel_matches_plain(arch, dtype, cache_dtype,
                                                    tol):
    """Each LM smoke config on the card: prefill and 3 teacher-forced
    decode steps through the ``flash_attention`` kernel against the same
    steps on the plain path (``layers.plain_attention``; an MoE layer on
    the kernel path's routing, ``moe.routing_log``, so that a near-tie
    bf16 rounding flips does not hide the difference measured), logits
    within ``tol`` × max(1, max |logit|) (``BF16_TOL`` where a config
    needs more in bf16); the attention launches equal the sum of the
    plans' launches (``lm_planned_launches``: prefill in the weights'
    dtype, dense decode in the cache's).  qwen1.5-110b smoke has head dim
    8, which the kernel runs padded to 16; rwkv6 smoke has no attention
    (0 launches) and runs its recurrent states on the card."""
    dev = _card()
    from repro_torch.configs import get_smoke
    from repro_torch.device import strict_float32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers, moe
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import encode, model_defs
    from repro_torch.serving.cache import init_cache
    from repro_torch.serving.engine import decode_step, prefill

    cfg = get_smoke(arch)
    b, s, max_seq = 2, 20, 48
    params = init_params(model_defs(cfg), seed=0, dtype=dtype, device=dev)
    rng = np.random.default_rng(11)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab, (b, s))).to(dev)
    steps = torch.from_numpy(rng.integers(0, cfg.vocab, (3, b))).to(dev)
    extra = {}
    if cfg.frontend_prefix:
        extra["prefix_embed"] = torch.from_numpy(rng.normal(
            0, 0.5, (b, cfg.frontend_prefix, cfg.d_model))).to(dev, dtype)
    if cfg.encoder_layers:
        extra["frames"] = torch.from_numpy(rng.normal(
            0, 0.5, (b, cfg.encoder_seq, cfg.d_model))).to(dev, dtype)
    planned = lm_planned_launches(fa, cfg, b, s, max_seq, 3, dtype,
                                  cache_dtype, fa.device_sm_count(dev))
    pos = s + cfg.frontend_prefix

    def run():
        cache = init_cache(cfg, b, max_seq, cache_dtype, dev)
        logits, cache = prefill(params, cfg, prompt, cache, **extra)
        enc_out = (encode(params, cfg, extra["frames"])
                   if cfg.encoder_layers else None)
        out = [logits]
        for t in range(3):
            logits, cache = decode_step(params, cfg, cache, steps[t],
                                        pos + t, enc_out=enc_out)
            out.append(logits)
        return out

    with strict_float32(), torch.inference_mode():
        before = ops.attention_launches
        with moe.routing_log() as routes:
            got = run()
        torch.cuda.synchronize()
        launched = ops.attention_launches - before
        with layers.plain_attention(), moe.routing_log(replay=routes):
            want = run()
        assert ops.attention_launches - before == launched == planned
    if dtype == torch.bfloat16:
        tol = BF16_TOL.get(arch, tol)
    for g, w in zip(got, want):
        g, w = g[:, :cfg.vocab].float(), w[:, :cfg.vocab].float()
        assert torch.isfinite(g).all()
        bound = tol * max(1.0, float(w.abs().max()))
        assert float((g - w).abs().max()) <= bound


# A train step's gradients move with float32 rounding alone by up to this
# share of max |leaf| (``F32_DEVIATION`` of tests/test_torch_train_archs.py,
# measured against a float64 run on the CPU), and the kernel's forward
# differs from the plain one by more than a rounding (2e-5 a call): the
# kernel-vs-plain tolerance is twice that noise, at least 1e-4.  On the
# CPU, with the kernel's split-TF32 products emulated
# (``ref.attention_tf32_ref``, terms=3) in place of the launch, whisper-base
# and gemma3 lie 8.9e-4 and 6.8e-4 of max |leaf| from the plain path (2e-3
# allowed), the other configs ≤ 5.2e-5; on the card moonshot lay 1.09e-4
F32_TRAIN_NOISE = {
    "lm100m": 6.41e-5, "qwen2.5-3b": 8.44e-5, "qwen1.5-110b": 6.42e-5,
    "nemotron-4-340b": 4.20e-5, "gemma3-1b": 5.11e-4,
    "internvl2-26b": 1.27e-4, "whisper-base": 2.31e-3,
    "mixtral-8x22b": 1.43e-4, "moonshot-v1-16b-a3b": 2.73e-4,
    "jamba-1.5-large-398b": 9.39e-4, "rwkv6-7b": 1.49e-4}
TRAIN_F32_TOL = {"whisper-base": 2e-3, "gemma3-1b": 2e-3}


def train_tolerance(arch: str) -> float:
    return max(TRAIN_F32_TOL.get(arch, 1e-4), 2 * F32_TRAIN_NOISE[arch])


def lm_train_planned_launches(fa, cfg, b: int, s_all: int, dtype,
                              sms: int, recompute: int = 1) -> int:
    """The attention launches of one forward of a train step (``recompute``
    forwards: 2 where remat recomputes each block), summed over the plans
    of every call at the padded head dim: a causal self-attention a
    decoder layer (windowed on local/SWA layers), and on an
    encoder-decoder a non-causal one an encoder layer and a
    cross-attention a decoder layer."""
    d = fa.padded_head_dim(cfg.head_dim)
    heads = (b, cfg.n_heads, cfg.n_kv_heads)
    n = 0
    if cfg.encoder_layers:
        t_enc = cfg.encoder_seq
        n += cfg.encoder_layers * fa.plan(*heads, t_enc, t_enc, d, dtype,
                                          causal=False, sm_count=sms).launches
        n += cfg.n_layers * fa.plan(*heads, s_all, t_enc, d, dtype,
                                    causal=False, sm_count=sms).launches
    for kind in cfg.layer_schedule():
        if kind.startswith("attn"):
            window = (cfg.local_window if kind in ("attn_local", "attn_swa")
                      else None)
            n += fa.plan(*heads, s_all, s_all, d, dtype, window=window,
                         sm_count=sms).launches
    return recompute * n


def _train_batch(cfg, b, s, dtype, dev, seed=12):
    rng = np.random.default_rng(seed)
    s_tok = s - cfg.frontend_prefix
    batch = {"tokens": rng.integers(0, cfg.vocab, (b, s_tok)),
             "labels": rng.integers(0, cfg.vocab, (b, s_tok))}
    if cfg.frontend_prefix:
        batch["prefix_embed"] = rng.normal(
            0, 0.5, (b, cfg.frontend_prefix, cfg.d_model))
    if cfg.encoder_layers:
        batch["frames"] = rng.normal(0, 0.5, (b, cfg.encoder_seq,
                                              cfg.d_model))
    return {k: torch.from_numpy(v).to(dev, dtype if v.dtype.kind == "f"
                                      else torch.long)
            for k, v in batch.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("arch, remat", [(a, "none") for a in LM_SMOKE]
                         + [("lm100m", "dots"), ("qwen2.5-3b", "full")])
def test_lm_train_step_kernel_matches_plain(arch, remat):
    """One float32 train step's gradients on the card, the kernel path
    against the same step inside ``layers.plain_attention`` (MoE layers on
    the kernel path's routing, ``moe.routing_log``): loss and grad norm
    within ``tol`` relative, every gradient leaf within ``tol`` × its max
    |value| (``train_tolerance``).
    The attention launches equal the plans' sum, twice it where remat
    recomputes the blocks, and the plain step launches none.  (A bf16
    step's gradients are not compared: bf16 rounding through the layers
    moves them 0.07-2.6 of max |leaf| between any two attention
    schedules, measured on the CPU; ``test_attention_grad_kernel_
    matches_plain`` holds the bf16 op to its gate.)"""
    import dataclasses
    dev = _card()
    from repro_torch.configs import get_smoke
    from repro_torch.device import strict_float32
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers, moe
    from repro_torch.models.params import init_params, tree_items
    from repro_torch.models.transformer import model_defs
    from repro_torch.optim.adamw import global_norm
    from repro_torch.train.train_step import TrainConfig, make_grad_fn

    cfg = dataclasses.replace(get_smoke(arch), remat=remat)
    b, s = 2, 32
    params = init_params(model_defs(cfg), seed=0, dtype=torch.float32,
                         device=dev)
    is_t = lambda x: isinstance(x, torch.Tensor)
    for _, p in tree_items(params, is_t):
        p.requires_grad_(True)
    batch = _train_batch(cfg, b, s, torch.float32, dev)
    planned = lm_train_planned_launches(
        fa, cfg, b, s, torch.float32, fa.device_sm_count(dev),
        recompute=1 if remat == "none" else 2)
    grad_fn = make_grad_fn(cfg, TrainConfig())
    with strict_float32():
        before = ops.attention_launches
        with moe.routing_log() as routes:
            loss, _, grads = grad_fn(params, batch)
        torch.cuda.synchronize()
        launched = ops.attention_launches - before
        with layers.plain_attention(), moe.routing_log(replay=routes):
            want_loss, _, want = grad_fn(params, batch)
        assert ops.attention_launches - before == launched == planned
    tol = train_tolerance(arch)
    assert torch.isfinite(loss)
    assert abs(float(loss - want_loss)) <= tol * abs(float(want_loss))
    gn, wn = float(global_norm(grads)), float(global_norm(want))
    assert abs(gn - wn) <= tol * wn
    for (path, g), (_, w) in zip(tree_items(grads, is_t),
                                 tree_items(want, is_t)):
        assert torch.isfinite(g).all(), path
        assert float((g - w).abs().max()) <= tol * max(
            1e-30, float(w.abs().max())), path


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,kw", [
    ((2, 10, 2, 256, 256, 64), dict(causal=True)),
    ((1, 4, 1, 300, 300, 256), dict(causal=True, window=64)),
    ((2, 8, 8, 40, 96, 64), dict(causal=False)),
    ((2, 4, 2, 64, 160, 8), dict(causal=True, q_offset=96))])
def test_attention_grad_kernel_matches_plain(shape, kw, dtype):
    """The op under grad on the card, launched through
    ``ops.with_plain_backward``: the output carries a ``grad_fn``, is the
    kernel's (the launches of its plan; the attention gate against
    ``attention_ref``), and q, k and v get exactly the gradients of the
    plain ``chunked_attention`` on the same operands.  ``ops.attention``
    alone refuses operands that require grad, launching nothing."""
    import functools
    dev = _card()
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import layers
    b, h, hkv, sq, skv, d = shape
    rng = np.random.default_rng(sq + skv + d)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dev, dtype).requires_grad_(True)
               for s in ((b, h, sq, d), (b, hkv, skv, d), (b, hkv, skv, d)))
    plain = functools.partial(layers.chunked_attention, q_chunk=64,
                              kv_chunk=64, **kw)
    before = ops.attention_launches
    with pytest.raises(RuntimeError, match="no backward"):
        ops.attention(q, k, v, **kw)
    assert ops.attention_launches == before
    out = ops.with_plain_backward(functools.partial(ops.attention, **kw),
                                  plain, q, k, v)
    launched = ops.attention_launches - before
    assert out.grad_fn is not None
    assert launched == fa.plan(b, h, hkv, sq, skv, fa.padded_head_dim(d),
                               dtype, sm_count=fa.device_sm_count(dev),
                               **kw).launches
    want = ref.attention_ref(q.detach(), k.detach(), v.detach(), **kw)
    atol, rtol = (2e-5, 2e-5) if dtype == torch.float32 else (4e-3, 2 ** -7)
    diff = (out.detach().float() - want.float()).abs()
    assert bool((diff <= atol + rtol * want.float().abs()).all())
    ct = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(dev, dtype)
    got = torch.autograd.grad(out, (q, k, v), ct)
    qd, kd, vd = (t.detach().requires_grad_(True) for t in (q, k, v))
    wanted = torch.autograd.grad(plain(qd, kd, vd), (qd, kd, vd), ct)
    torch.cuda.synchronize()
    assert ops.attention_launches - before == launched
    for g, w in zip(got, wanted):
        assert g.dtype == dtype and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["phase3_first", "every_vec16_tile"])
def test_vta_gemm_one_stage_repeat(case):
    """The one-stage ``vec16`` geometries launched 200 times each into
    fresh buffers filled with a sentinel byte (0x5A and 0xA5 in turns):
    every run equals the plain version, so no element is written wrong
    or left unwritten (``chip_smoke.py`` phase 3 runs the same at 256)."""
    dev = _card()
    from repro_torch.kernels import vta_gemm as vg
    sms = vg.device_sm_count(dev)
    if case == "phase3_first":
        cases = [(25088, 32, 16, vg.plan(25088, 32, 16, sm_count=sms))]
    else:
        cases = [(196 * bm, 32 * ks, bn,
                  vg.make_plan(196 * bm, 32 * ks, bn, bm, bn, ks, load))
                 for bm, bn, ks, load in vg.INSTANTIATIONS
                 if load == "vec16"]
    rng = np.random.default_rng(23)
    for m, k, n, p in cases:
        assert (p.stages, p.load) == (1, "vec16")
        a, b = _int8(rng, (m, k), dev), _int8(rng, (k, n), dev)
        want = ref.vta_gemm_ref(a, b, None, saturate=False)
        for r in range(200):
            sentinel = (0x5A, -0x5B)[r % 2]
            out = torch.full((m, n), sentinel, dtype=torch.int8, device=dev)
            vg._launch(a, b, None, out, p, saturate=False)
            wrong = out != want
            assert not bool(wrong.any()), (
                (m, k, n), r, int(wrong.sum()),
                int((wrong & (out == sentinel)).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compressed_pod_allreduce_one_rank(tmp_path, dtype):
    """``compressed_pod_allreduce`` on CUDA tensors at one rank of a
    (1, 1, 1) pod mesh over NCCL equals the numpy replica of the
    reference's ``_compress_body`` with n_pods = 1 (its divisions by
    constants as float32 reciprocal multiplications, as XLA compiles
    them), bit for bit."""
    dev = _card()
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.train.distributed import compressed_pod_allreduce
    init_distributed(dev, init_method=f"file://{tmp_path}/store", rank=0,
                     world_size=1, timeout_s=60)
    try:
        mesh = make_mesh((1, 1, 1), ("pod", "data", "model"))
        rng = np.random.default_rng(7)
        grads = {"a": rng.standard_normal((64, 33)).astype(np.float32),
                 "b": (rng.standard_normal(1000) * 1e-3).astype(np.float32),
                 "z": np.zeros((3, 4), np.float32)}
        out = compressed_pod_allreduce(
            {k: torch.from_numpy(v).to(dev, dtype) for k, v in grads.items()},
            mesh)
        for key, g in grads.items():
            g = torch.from_numpy(g).to(dtype).float().numpy()
            limit = 127
            scale = np.float32(max(np.float32(np.max(np.abs(g))),
                                   np.float32(1e-12))
                               * np.float32(1.0 / limit))
            q = np.clip(np.round(g / scale), -limit, limit).astype(np.int8)
            want = torch.from_numpy((q.astype(np.float32) * scale)
                                    * np.float32(1.0)).to(dtype)
            assert out[key].dtype == dtype
            assert torch.equal(out[key].cpu(), want), key
    finally:
        dist.destroy_process_group()
