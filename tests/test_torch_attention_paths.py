"""The attention paths' plan and plain versions, on the CPU.

``csrc/flash_attention.cu`` and ``csrc/flash_attention_bf16.cu`` run only
on a card; what surrounds them is tested here on numpy-seeded inputs at
small sizes:

* ``ref.attention_split_ref`` (the plain version of the split path: float32
  partials per KV split, merged as the combine kernel merges them) against
  ``ref.attention_ref`` and against the JAX package's ``attention_ref``,
  float32 and bf16, 1–7 splits: unequal splits, splits in which a row keeps
  no key, rows that keep none, windows narrower than a split;
* ``flash_attention.plan``: the path, grid and shared memory of every case
  ``chip_smoke.py`` runs, the float32 path's tiles per head dim and its KV
  split rule;
* the precision design: P kept as two bf16 parts passes the bf16 gate of
  ``chip_smoke.py`` at the qwen2.5-3b decode shape (batch and heads cut),
  and P rounded to bf16 alone does not.

Tolerances: float32 atol = rtol = 2e-5 (the reference's kernel tests); bf16
atol 4e-3 + rtol 2**-7, as ``tests/test_torch_attention.py``.
"""

import dataclasses
import importlib.util
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

from repro.kernels import ref as jref                            # noqa: E402
from repro_torch.kernels import flash_attention as fa            # noqa: E402
from repro_torch.kernels import ref as tref                      # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 4e-3, 2.0 ** -7)}


def _inputs(seed, b, h, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, h, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _torch(xs, dtype):
    return tuple(torch.from_numpy(x).to(DTYPES[dtype][1]) for x in xs)


def _close(got, want, dtype):
    atol, rtol = DTYPES[dtype][2:]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# (b, h, hkv, sq, skv, d), kwargs
SPLIT_CASES = [
    ((2, 4, 2, 1, 37, 16), dict(causal=True, q_offset=36)),     # decode
    ((1, 4, 1, 5, 53, 32), dict(causal=False)),                 # ragged
    ((1, 2, 2, 12, 20, 16), dict(causal=True, q_offset=-4)),    # empty rows
    ((1, 4, 2, 6, 64, 32), dict(causal=True, window=3, q_offset=58)),
    ((1, 2, 1, 8, 40, 16), dict(causal=True, window=5, q_offset=10)),
]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("splits", [1, 2, 3, 5, 7])
@pytest.mark.parametrize("shape,kw", SPLIT_CASES)
def test_split_ref_matches_reference_and_jax(shape, kw, splits, dtype):
    xs = _inputs(sum(shape) + splits, *shape)
    q, k, v = _torch(xs, dtype)
    got = tref.attention_split_ref(q, k, v, splits=splits, **kw)
    assert got.dtype == q.dtype
    want = tref.attention_ref(q, k, v, **kw)
    _close(got.float().numpy(), want.float().numpy(), dtype)
    jt = DTYPES[dtype][0]
    jax_out = np.asarray(jref.attention_ref(*(jnp.asarray(x, jt) for x in xs),
                                            **kw), np.float32)
    _close(got.float().numpy(), jax_out, dtype)


def test_split_partials_cover_edge_splits():
    """Unequal splits (the last is short), a split in which some rows keep
    no key, a row that keeps none at all, and a window narrower than a
    split; the empty parts have m = -inf, l = 0, acc = 0 and weigh 0."""
    q, k, v = _torch(_inputs(5, 1, 2, 1, 6, 23, 16), "float32")
    kw = dict(causal=True, q_offset=-1, window=4)
    out, m, l, acc = tref.attention_split_ref(q, k, v, splits=3, chunk=8,
                                              partials=True, **kw)
    assert m.shape == l.shape == (3, 1, 2, 6)
    assert acc.shape == (3, 1, 2, 6, 16)
    # row 0 is at position -1: no key anywhere
    assert torch.all(torch.isinf(m[:, :, :, 0]))
    assert torch.all(out[:, :, 0] == 0)
    # the last split (keys 16..22) keeps nothing for these rows
    assert torch.all(torch.isinf(m[2])) and torch.all(l[2] == 0)
    assert torch.all(acc[2] == 0)
    assert torch.isfinite(out).all()
    _close(out.numpy(), tref.attention_ref(q, k, v, **kw).numpy(), "float32")
    with pytest.raises(ValueError, match="do not cover"):
        tref.attention_split_ref(q, k, v, splits=2, chunk=8)


def test_split_partials_are_base_two():
    """m is the largest kept score times log2(e); l sums 2^(s log2 e - m)."""
    q, k, v = _torch(_inputs(8, 1, 1, 1, 3, 10, 16), "float32")
    _, m, l, acc = tref.attention_split_ref(q, k, v, splits=2, chunk=5,
                                            causal=False, partials=True)
    s = (q[0, 0] @ k[0, 0].T) * 16 ** -0.5 * tref.LOG2E
    for i, part in enumerate((s[:, :5], s[:, 5:])):
        torch.testing.assert_close(m[i, 0, 0], part.amax(dim=-1))
        p = torch.exp2(part - part.amax(dim=-1, keepdim=True))
        torch.testing.assert_close(l[i, 0, 0], p.sum(dim=-1))
        torch.testing.assert_close(acc[i, 0, 0],
                                   p @ v[0, 0, 5 * i:5 * i + 5])


def _all_cases():
    cases = [(c["shape"], c["dtype"], dict(causal=c["causal"],
                                            window=c["window"],
                                            q_offset=c["q_offset"]))
             for c in smoke.ATTN_FULL]
    for shape, kw in smoke.attention_grid():
        for dtype in (torch.float32, torch.bfloat16):
            cases.append((shape, dtype, kw))
    cases += [(c["shape"], c["dtype"], dict(causal=c["causal"],
                                             window=c["window"],
                                             q_offset=c["q_offset"]))
              for c in smoke.FAMILY_CALLS]
    return cases


def test_plan_gives_every_case_a_path():
    """Every full-width and grid case of chip_smoke.py gets a path: float32
    always ``f32`` on an instantiation the library holds, bf16 always a
    bf16 path, shared memory within a block's limit, the launches the path
    makes (2 where a split adds the combine)."""
    seen = set()
    for shape, dtype, kw in _all_cases():
        p = fa.plan(*shape, dtype, **kw)
        seen.add(p.path)
        if dtype == torch.float32:
            assert p.path == "f32"
            assert (shape[5], p.block_q, p.block_kv, p.stages) in \
                fa.F32_INSTANTIATIONS
            assert p.launches == (1 if p.splits == 1 else 2)
        else:
            assert p.path in ("bf16_tiles", "bf16_split")
            assert p.launches == (1 if p.path == "bf16_tiles"
                                  and p.splits == 1 else 2)
        assert 0 < p.smem_bytes <= fa.SMEM_LIMIT
        assert p.blocks >= 1 and p.splits >= 1
    assert seen == {"f32", "bf16_tiles", "bf16_split"}


@pytest.mark.parametrize("d", [16, 32, 64, 128, 192, 256])
def test_plan_shared_memory_per_head_dim(d):
    for dtype, shape in ((torch.float32, (1, 4, 2, 300, 300, d)),
                         (torch.bfloat16, (1, 4, 2, 300, 300, d)),
                         (torch.bfloat16, (4, 8, 1, 1, 300, d))):
        p = fa.plan(*shape, dtype)
        assert p.smem_bytes <= fa.SMEM_LIMIT, (p, d)


def test_plan_nemotron_head_dim_192():
    """nemotron-4-340b (H 96, Hkv 8, D 192) gets each path on the
    instantiation its sources hold: f32 on (192, 64, 16, 2), bf16 prefill
    on 64-key tiles, decode on the split path, all within a block's shared
    memory."""
    f32 = fa.plan(1, 96, 8, 2048, 2048, 192, torch.float32)
    assert f32.path == "f32" and (192, f32.block_q, f32.block_kv,
                                  f32.stages) in fa.F32_INSTANTIATIONS
    pre = fa.plan(1, 96, 8, 2048, 2048, 192, torch.bfloat16)
    assert (pre.path, pre.block_kv, pre.stages) == ("bf16_tiles", 64, 3)
    dec = fa.plan(8, 96, 8, 1, 4096, 192, torch.bfloat16, q_offset=4095)
    assert dec.path == "bf16_split" and dec.launches == 2
    for p in (f32, pre, dec):
        assert 0 < p.smem_bytes <= fa.SMEM_LIMIT, p


def test_plan_full_width_cases():
    by_name = {c["name"]: fa.plan(*c["shape"], c["dtype"], causal=c["causal"],
                                  window=c["window"], q_offset=c["q_offset"])
               for c in smoke.ATTN_FULL}
    decode = by_name["qwen2.5-3b decode"]
    assert decode.path == "bf16_split" and decode.blocks >= fa.SM_COUNT
    assert (decode.splits, decode.chunk, decode.grid) == (16, 256, (16, 2, 8))
    assert decode.launches == 2
    prefill = by_name["qwen2.5-3b prefill"]
    assert prefill.path == "bf16_tiles" and prefill.splits == 1
    assert prefill.grid == (32 * 16, 1, 1) and prefill.blocks == 512
    chunked = by_name["qwen2.5-3b chunked prefill"]
    assert chunked.path == "bf16_tiles" and chunked.splits > 1
    assert chunked.blocks >= fa.SM_COUNT and chunked.launches == 2
    local = by_name["gemma3-1b local layer"]
    assert local.path == "bf16_tiles" and local.splits == 1
    assert local.block_kv == 64
    whisper = by_name["whisper-base cross-attention"]
    assert whisper.path == "f32" and (whisper.block_q, whisper.block_kv) == (
        128, 64)
    assert (whisper.splits, whisper.blocks, whisper.launches) == (4, 128, 2)
    lm = by_name["lm100m"]
    assert lm.path == "f32" and lm.splits == 1 and lm.launches == 1
    assert lm.grid == (8 * 10 * 4, 1, 1)


def test_plan_split_threshold():
    """The split path takes a GQA group whose packed rows fit 16."""
    bf = torch.bfloat16
    assert fa.plan(1, 8, 1, 2, 517, 128, bf, q_offset=515).path == "bf16_split"
    assert fa.plan(1, 8, 1, 3, 517, 128, bf, q_offset=514).path == "bf16_tiles"
    assert fa.plan(1, 16, 1, 1, 64, 64, bf, q_offset=63).path == "bf16_split"
    assert fa.plan(1, 17, 1, 1, 64, 64, bf, q_offset=63).path == "bf16_tiles"
    # splits are counted from key 0, cover every key, and each is whole tiles
    for skv, off, window in ((4096, 4095, None), (77, 76, None),
                             (4096, 4095, 512), (10, -3, None)):
        p = fa.plan(2, 8, 2, 1, skv, 64, bf, window=window, q_offset=off)
        assert p.chunk % fa.SPLIT_TILE == 0
        assert p.splits * p.chunk >= min(skv, max(off + 1, 0))
    assert fa.plan(1, 8, 2, 1, 10, 64, bf, q_offset=-3).splits == 1


def test_scratch_size():
    p = fa.plan(8, 16, 2, 1, 4096, 128, torch.bfloat16, q_offset=4095)
    assert p.scratch_floats == 16 * 8 * 16 * 130
    tiles = fa.plan(1, 16, 2, 4096, 4096, 128, torch.bfloat16)
    assert tiles.scratch_floats == 0


def test_plan_follows_the_sm_count():
    """The wave sizes come from the card's SM count: fewer SMs, fewer
    splits at decode; a split count forced on the tiles path keeps the
    grid, launches and scratch consistent."""
    bf = torch.bfloat16
    decode = dict(causal=True, q_offset=4095)
    full = fa.plan(8, 16, 2, 1, 4096, 128, bf, **decode)
    small = fa.plan(8, 16, 2, 1, 4096, 128, bf, **decode, sm_count=66)
    assert (full.splits, small.splits) == (16, 8)
    chunked = fa.plan(1, 16, 2, 512, 4096, 128, bf, q_offset=3584)
    one = dataclasses.replace(chunked, splits=1)
    assert chunked.blocks == 64 * chunked.splits and one.blocks == 64
    assert (one.launches, one.scratch_floats) == (1, 0)
    assert chunked.launches == 2 and chunked.scratch_floats > 0


def test_c_plan_fields():
    """What the C entry points receive: the path code, tiles, stages,
    splits, chunk, shared memory and grid of the plan."""
    p = fa.plan(8, 16, 2, 1, 4096, 128, torch.bfloat16, q_offset=4095)
    c = p.c_plan()
    assert [getattr(c, f) for f, _ in c._fields_] == [
        2, 16, 64, 3, 16, 256, p.smem_bytes, 16, 2, 8]
    f = fa.plan(1, 8, 8, 448, 1500, 64, torch.float32, causal=False).c_plan()
    assert (f.path, f.block_q, f.block_kv, f.stages, f.splits, f.chunk) == (
        0, 128, 64, 2, 4, 0)
    assert (f.gx, f.gy, f.gz) == (4 * 4 * 8, 1, 1)
    assert f.smem == 4 * 68 * 6 * 64


def test_plan_tiles_match_the_sources():
    """plan's tiles and stages are the ones the C sources instantiate (the
    libraries refuse any other geometry on the card; this finds a drift
    on the CPU)."""
    f32 = fa.SOURCE.read_text()
    bf16 = fa.SOURCE_BF16.read_text()
    held = {(int(d), 16 * int(w), int(bk), int(st)): (q == "true", int(nb))
            for d, w, bk, st, q, nb in re.findall(
                r"^  FA_CASE\((\d+), (\d+), (\d+), (\d+), (true|false), "
                r"(\d+)\)$", f32, re.M)}
    assert held == fa.F32_INSTANTIATIONS
    for d, tile in fa.F32_TILES.items():
        assert (d, *tile) in held
    assert {int(d): int(bk) for d, bk in re.findall(
        r"launch_tiles<(\d+), (\d+)>", bf16)} == fa.TILE_KV
    assert re.search(rf"BQ = {fa.TILE_Q};", bf16)
    assert re.search(rf"SPLIT_ROWS = {fa.SPLIT_ROWS};", bf16)
    assert re.search(rf"SPLIT_TILE = {fa.SPLIT_TILE};", bf16)
    stages = re.findall(r"STAGES = D <= (\d+) \? (\d+) : (\d+);", bf16)
    assert len(stages) == 2
    for top, low, high in stages:
        assert fa.BF16_STAGES == {d: int(low) if d <= int(top) else int(high)
                                  for d in fa.SUPPORTED_HEAD_DIMS}


def test_alignment_check():
    """A contiguous view at an odd storage offset is refused before any
    launch."""
    base = torch.zeros(4 * 32 + 1, dtype=torch.bfloat16)
    ok = base[:128].view(1, 1, 4, 32)
    fa.check_alignment(ok)
    odd = base[1:].view(1, 1, 4, 32)
    assert odd.is_contiguous()
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa.check_alignment(ok, odd)


@pytest.mark.parametrize("p_split,passes", [(True, True), (False, False)])
def test_precision_design_at_decode_shape(p_split, passes):
    """qwen2.5-3b decode, batch 2 and 4 query heads (of 8 and 16): P as
    hi + lo passes chip_smoke.py's bf16 gate; P rounded to bf16 alone
    changes about 40 % of the values and is refused."""
    shape = (2, 4, 2, 1, 4096, 128)
    q, k, v = _torch(_inputs(11, *shape), "bfloat16")
    kw = dict(causal=True, q_offset=4095)
    want = tref.attention_ref(q, k, v, **kw)
    got = tref.attention_rounded_p(q, k, v, p_split=p_split, **kw)
    st = smoke.attention_stats(got, want)
    if passes:
        smoke.attention_err(got, want)
        assert st["mismatch_share"] < 0.02
    else:
        with pytest.raises(AssertionError, match="bf16 values differ"):
            smoke.attention_err(got, want)
        assert st["mismatch_share"] > 0.3


def test_precision_emulation_in_float32():
    """With float32 inputs the split-P emulation agrees with the plain
    version to ~2^-16 relative of P."""
    q, k, v = _torch(_inputs(12, 1, 2, 1, 16, 300, 64), "float32")
    kw = dict(causal=True, q_offset=284)
    got = tref.attention_rounded_p(q, k, v, p_split=True, **kw)
    _close(got.numpy(), tref.attention_ref(q, k, v, **kw).numpy(), "float32")


def test_f32_routing_per_head_dim():
    """Every head dim goes to the tensor-core ``f32`` path on the tile of
    ``F32_TILES``: Q fragments in registers up to D = 64, from shared
    memory at D = 128 and 256 (the accumulator needs the registers); the
    shared memory lets the instantiation's blocks share an SM."""
    for d in fa.SUPPORTED_HEAD_DIMS:
        p = fa.plan(2, 4, 2, 300, 300, d, torch.float32)
        assert p.path == "f32"
        assert (p.block_q, p.block_kv, p.stages) == fa.F32_TILES[d]
        qreg, per_sm = p.f32_instance
        assert qreg == (d <= 64)
        assert per_sm * (p.smem_bytes + 1024) <= 233_472
        assert p.smem_bytes == 4 * (d + 4) * (
            (0 if qreg else p.block_q) + (2 * p.stages + 2) * p.block_kv)


@pytest.mark.parametrize("base,tiles,slots,want", [
    (320, 16, 132, 1),      # lm100m: the q tiles fill the card
    (32, 24, 132, 4),       # whisper-base: 4 x 6 tiles, one wave
    (56, 24, 264, 4),       # 64-row tiles, two blocks an SM: one wave
    (56, 47, 396, 7),       # three blocks an SM
    (1, 1, 132, 1),         # one tile: nothing to split
    (2, 5, 132, 5),         # one tile a split fills no more than a wave
    (100, 3, 132, 1),       # a second wave would cost more than it gains
])
def test_f32_split_rule(base, tiles, slots, want):
    """The fewest splits that minimise waves x KV tiles a block, counting
    only splits that get a tile."""
    assert fa._f32_splits(base, 0, tiles * 64, 64, slots) == want


def test_f32_split_plan_cases():
    """whisper-base splits its 32 q-tile blocks into one wave that holds
    nearly every SM; lm100m does not split; a grid over the keys that no
    row keeps is never split; the scratch holds every split's partials."""
    f32 = torch.float32
    whisper = fa.plan(1, 8, 8, 448, 1500, 64, f32, causal=False)
    slots = fa.SM_COUNT * whisper.f32_instance[1]
    assert whisper.splits > 1 and 0.9 * slots <= whisper.blocks <= slots
    assert whisper.scratch_floats == 4 * 8 * 448 * 66
    lm = fa.plan(4, 10, 2, 1024, 1024, 64, f32)
    assert lm.splits == 1 and lm.blocks >= fa.SM_COUNT
    assert lm.scratch_floats == 0
    empty = fa.plan(1, 2, 2, 10, 10, 64, f32, q_offset=-20)
    assert empty.splits == 1 and empty.launches == 1
    # fewer SMs: fewer splits for the same one-wave grid
    assert fa.plan(1, 8, 8, 448, 1500, 64, f32, causal=False,
                   sm_count=66).splits == 2


@pytest.mark.parametrize("name,tensor_cores,cuda_cores", [
    ("lm100m", 0.032569, 0.080208),
    ("whisper-base cross-attention", 0.0083409, 0.020541),
])
def test_float32_bound_is_the_faster_scheme(name, tensor_cores, cuda_cores):
    """chip_smoke.py's float32 bound is the least time of the faster of
    the card's two ways to take float32 products: three TF32 products at
    495 TFLOP/s beat 4·D operations at 67 TFLOP/s on the CUDA cores, which
    stays beside it; both cases are bound by operations, not bytes."""
    case = {c["name"]: c for c in smoke.ATTN_FULL}[name]
    t, by = smoke.attention_bound(case)
    assert by == "operations" and t == pytest.approx(tensor_cores, rel=1e-4)
    t_cc, by_cc = smoke.attention_bound(case, cuda_cores=True)
    assert by_cc == "operations" and t_cc == pytest.approx(cuda_cores,
                                                           rel=1e-4)


def test_plan_phase_21_calls():
    """Phase 21's geometries: GQA group 6 (internvl2-26b's 48 heads over
    8) packs its 6 decode rows into ``bf16_split`` and takes
    ``bf16_tiles`` in prefill; so does jamba's group 8; gemma3-1b's D =
    256 local prefill keeps only the window's KV tiles; whisper-base's
    1,500 frames split only the single-row cross decode.  Every call of
    each family's serve (``family_calls`` over its own prompts) gets a
    path on an instantiation the libraries hold."""
    by_name = {c["name"]: fa.plan(*c["shape"], c["dtype"],
                                  causal=c["causal"], window=c["window"],
                                  q_offset=c["q_offset"])
               for c in smoke.FAMILY_CALLS}
    for fam in ("internvl2-26b", "jamba attention"):
        dec, pre = by_name[f"{fam} decode"], by_name[f"{fam} prefill"]
        assert dec.path == "bf16_split" and dec.launches == 2
        assert pre.path == "bf16_tiles" and pre.splits == 1
    assert by_name["internvl2-26b decode"].shape[1:3] == (48, 8)
    local = by_name["gemma3-1b local prefill"]
    assert (local.path, local.block_q, local.block_kv) == ("f32", 64, 16)
    assert fa.kept_range(1024, 1024, True, 512, 0) == (0, 1024)
    assert fa.kept_range(1, 1024, True, 512, 1023) == (512, 1024)
    assert by_name["whisper-base encoder"].splits == 1
    assert by_name["whisper-base cross decode"].splits > 1
    for fam in smoke.FAMILIES:
        cfg = smoke.family_config(fam)
        for s_all in (256, 1024):
            s_all = min(s_all, fam["max_seq"] - smoke.FAMILY_NEW)
            calls = smoke.family_calls(
                fa, cfg, smoke.FAMILY_BATCH, s_all, fam["max_seq"],
                range(s_all, s_all + smoke.FAMILY_NEW - 1), encodes=2)
            for shape, kw in calls:
                p = fa.plan(*shape, fam["dtype"], **kw)
                assert 0 < p.smem_bytes <= fa.SMEM_LIMIT
                if fam["dtype"] == torch.float32:
                    assert (shape[5], p.block_q, p.block_kv, p.stages) in \
                        fa.F32_INSTANTIATIONS
                else:
                    group = shape[1] // shape[2]
                    assert p.path == ("bf16_split" if group * shape[3]
                                      <= fa.SPLIT_ROWS else "bf16_tiles")


def test_plan_phase_22_calls():
    """Phase 22's geometries: mixtral-8x22b's windowed prefill past its
    4,096 window on ``bf16_tiles`` (one launch), its ring decode on
    ``bf16_split`` with GQA group 6 packed (split kernel and combine);
    nemotron-4-340b's float32 prefill and decode at D = 192 on the
    ``(192, 64, 16, 2)`` instantiation; every call of each family's serve (``family_calls``
    over its own prompts) gets a path on an instantiation the libraries
    hold."""
    by_name = {c["name"]: fa.plan(*c["shape"], c["dtype"],
                                  causal=c["causal"], window=c["window"],
                                  q_offset=c["q_offset"])
               for c in smoke.big_family_calls()}
    pre = by_name["mixtral-8x22b windowed prefill"]
    assert pre.path == "bf16_tiles" and pre.launches == 1
    assert pre.shape[3] > 4096
    dec = by_name["mixtral-8x22b ring decode"]
    assert dec.path == "bf16_split" and dec.splits > 1 and dec.launches == 2
    for name in ("nemotron-4-340b prefill", "nemotron-4-340b decode"):
        p = by_name[name]
        assert p.path == "f32"
        assert (192, p.block_q, p.block_kv, p.stages) in fa.F32_INSTANTIATIONS
    for fam in smoke.BIG_FAMILIES:
        cfg = smoke.family_config(fam)
        work = smoke.family_prompts(fam, cfg)
        if fam["entry"] == "server":
            b = smoke.FAMILY_BATCH
            s_alls = [max(len(p) for p in work[g:g + b])
                      for g in range(0, len(work), b)]
        else:
            s_alls = [t.shape[1] for t, _ in work]
        for s_all in s_alls:
            calls = smoke.family_calls(
                fa, cfg, smoke.FAMILY_BATCH, s_all, fam["max_seq"],
                range(s_all, s_all + smoke.FAMILY_NEW - 1))
            assert len(calls) == cfg.n_layers * smoke.FAMILY_NEW
            for shape, kw in calls:
                p = fa.plan(*shape, fam["dtype"], **kw)
                assert 0 < p.smem_bytes <= fa.SMEM_LIMIT
                if fam["dtype"] == torch.float32:
                    assert (shape[5], p.block_q, p.block_kv, p.stages) in \
                        fa.F32_INSTANTIATIONS
                else:
                    group = shape[1] // shape[2]
                    assert p.path == ("bf16_split" if group * shape[3]
                                      <= fa.SPLIT_ROWS else "bf16_tiles")
