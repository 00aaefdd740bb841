"""The four families ``chip_smoke.py`` phase 21 serves at full width
(gemma3-1b, whisper-base, internvl2-26b and jamba cut to 4 layers), held
against the JAX package on the CPU at smoke size.

* ``serving.engine.generate`` against ``repro.serving.engine.generate``
  for whisper-base (with ``frames``), internvl2-26b (with
  ``prefix_embed``), gemma3-1b (a 20-token prompt over a window of 8: the
  ring has wrapped at prefill and every decode step overwrites its oldest
  slot) and jamba (Mamba, attention and MoE layers).  Before the tokens
  are compared, each of the reference's steps is replayed teacher-forced
  and its top-2 logit margin must exceed ten times ``LOGIT_TOL`` (a tie
  would say nothing about the port).
* The windowed ring's decode on the kernel takes the masks
  ``engine.ring_attention_args`` names; on the plain version those masks
  keep exactly the slots the reference's ``slot_pos`` mask keeps, before
  and after the ring wraps.
* Jamba's chunked scan against its recurrent step: a 256-token prefill
  against a 128-token prefill and 128 teacher-forced decode steps, at
  batch 1 (a decode's MoE capacity of 1 holds a token's two experts).
  The port's logits and states match the reference's doing the same
  split (``LOGIT_TOL`` and ``MAMBA_STATE_TOL`` of
  ``tests/test_torch_lm_serving.py``), its attention layers' K/V caches
  within ``SPLIT_KV_TOL``: after 128 steps through jamba smoke's
  ill-conditioned SSM state (max |h| ~5e4) the reference's own float32
  K/V lie up to 2.8e-4 of max |value| from the same split in float64, the
  port's 1.1e-4, the two packages 3.1e-4 apart.  Both packages' states
  and logits lie within phase 21's tolerances (``MAMBA_STATE_TOL`` /
  ``MAMBA_LOGIT_TOL`` of ``chip_smoke.py``) of the whole prefill.
* On ``meta`` (no allocation): each phase-21 configuration's weights and
  cache at its dtype fit the card's 80 GB, jamba's only at its 4-layer
  cut, which keeps each kind of layer the model has.

Float32 throughout; the port's attention runs its plain version.
"""

import dataclasses
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jax_smoke
from repro.models import transformer as jax_tr
from repro.serving import cache as jax_cache
from repro.serving import engine as jax_engine
from repro_torch.configs import get_config
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as port_moe
from repro_torch.models.params import param_count
from repro_torch.models.transformer import model_defs, stack_layout
from repro_torch.serving import cache as port_cache
from repro_torch.serving import engine as port_engine
from test_torch_lm_serving import (LOGIT_TOL, MAMBA_STATE_TOL, MAX_SEQ,
                                   both, cache_leaves, close, inputs)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

FAMILIES = ["whisper-base", "internvl2-26b", "gemma3-1b",
            "jamba-1.5-large-398b"]
NEW_TOKENS = 12
SPLIT = (128, 128)          # jamba smoke: prefill, then teacher-forced steps
SPLIT_KV_TOL = 1e-3


def _margins(logits, vocab: int) -> np.ndarray:
    top = np.sort(np.asarray(logits)[:, :vocab], axis=-1)
    return top[:, -1] - top[:, -2]


@pytest.mark.parametrize("arch", FAMILIES)
def test_generate_matches_jax(arch):
    jcfg, tcfg, jparams, tparams = both(arch, seed=21)
    tokens, extra, _ = inputs(tcfg, seed=22)
    jextra = {k: jnp.asarray(v) for k, v in extra.items()}
    textra = {k: torch.from_numpy(v) for k, v in extra.items()}
    jt = np.asarray(jax_engine.generate(jparams, jcfg, jnp.asarray(tokens),
                                        NEW_TOKENS, MAX_SEQ,
                                        dtype=jnp.float32, **jextra))
    tt = port_engine.generate(tparams, tcfg, torch.from_numpy(tokens),
                              NEW_TOKENS, MAX_SEQ, dtype=torch.float32,
                              **textra)
    assert tt.shape == (tokens.shape[0], NEW_TOKENS)
    # the reference's own steps, teacher-forced on its tokens: each
    # step's top-2 margin
    cache = jax_cache.init_cache(jcfg, tokens.shape[0], MAX_SEQ,
                                 jnp.float32)
    logits, cache = jax_engine.prefill(jparams, jcfg, jnp.asarray(tokens),
                                       cache, **jextra)
    enc_out = (jax_tr.encode(jparams, jcfg, jextra["frames"])
               if jcfg.encoder_layers else None)
    margins = [_margins(logits, jcfg.vocab)]
    step = jax.jit(jax_engine.decode_step, static_argnums=(1,))
    pos = tokens.shape[1] + jcfg.frontend_prefix
    for t in range(NEW_TOKENS - 1):
        logits, cache = step(jparams, jcfg, cache, jnp.asarray(jt[:, t]),
                             jnp.int32(pos + t), enc_out=enc_out)
        margins.append(_margins(logits, jcfg.vocab))
    assert np.min(margins) > 10 * LOGIT_TOL, np.min(margins, axis=1)
    assert np.array_equal(tt.numpy(), jt)


@pytest.mark.parametrize("slots", [8, 5])
def test_ring_decode_masks_keep_the_reference_slots(slots):
    """A ring filled in position order, one decode position at a time:
    the plain attention under ``ring_attention_args``' masks against the
    reference's decode over the ring with its ``slot_pos`` mask (the
    window at least the ring: ``min(window, max_seq)`` slots)."""
    window = 8
    rng = np.random.default_rng(slots)
    b, h, hkv, d = 2, 4, 1, 16
    k = np.zeros((b, hkv, slots, d), np.float32)
    v = np.zeros_like(k)
    slot_pos = np.full(slots, -1, np.int32)
    jcfg = jax_smoke("gemma3-1b")
    assert jcfg.local_window == window
    for pos in range(3 * slots):
        slot = pos % slots
        k[:, :, slot] = rng.normal(size=(b, hkv, d))
        v[:, :, slot] = rng.normal(size=(b, hkv, d))
        slot_pos[slot] = pos
        q = rng.normal(size=(b, h, 1, d)).astype(np.float32)
        valid = (slot_pos >= 0) & (pos - slot_pos < window)
        want = np.asarray(jax_engine._attn_scores_decode(
            jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
            jnp.asarray(valid)[None, None, None, :]))
        got = tref.attention_ref(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
            **port_engine.ring_attention_args(slots, pos))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-5)


def _split_run(prefill, decode_step, params, cfg, init, seq):
    """(whole prefill's (logits, cache), split's (logits, cache))."""
    n0, steps = SPLIT
    whole = prefill(params, cfg, seq, init())
    logits, cache = prefill(params, cfg, seq[:, :n0], init())
    for t in range(steps):
        logits, cache = decode_step(params, cfg, cache, seq[:, n0 + t],
                                    n0 + t)
    return whole, (logits, cache)


def _within(got, want, tol: float, what: str) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * scale, f"{what}: {err:.3g} > {tol} × {scale:.3g}"
    return err / scale


def test_jamba_scan_split_matches_jax_and_whole_prefill():
    jcfg, tcfg, jparams, tparams = both("jamba-1.5-large-398b", seed=23)
    n = sum(SPLIT)
    seq = np.random.default_rng(24).integers(0, tcfg.vocab, (1, n)
                                             ).astype(np.int32)
    with port_moe.routing_log() as routes:
        (tw, tw_cache), (ts, ts_cache) = _split_run(
            port_engine.prefill, port_engine.decode_step, tparams, tcfg,
            lambda: port_cache.init_cache(tcfg, 1, n, torch.float32, "cpu"),
            torch.from_numpy(seq))
    # no assignment beyond an expert's capacity, whole or split: the MoE
    # layers compute the same thing on both sides
    for ids in routes:
        cap = port_moe._capacity(ids.shape[1], tcfg.moe)
        assert int(torch.bincount(ids.reshape(-1)).max()) <= cap
    step = jax.jit(jax_engine.decode_step, static_argnums=(1,))
    (jw, jw_cache), (js, js_cache) = _split_run(
        jax_engine.prefill,
        lambda p, c, cache, tok, pos: step(p, c, cache, tok, jnp.int32(pos)),
        jparams, jcfg, lambda: jax_cache.init_cache(jcfg, 1, n, jnp.float32),
        jnp.asarray(seq))
    close(tw, jw, LOGIT_TOL, "whole prefill logits")
    close(ts, js, LOGIT_TOL, "split logits")
    mamba = 0
    for (path, t_leaf), (_, j_leaf), (_, w_leaf) in zip(
            cache_leaves(ts_cache), cache_leaves(js_cache),
            cache_leaves(tw_cache)):
        state = path.endswith(("/conv", "/h"))
        close(t_leaf, j_leaf, MAMBA_STATE_TOL if state else SPLIT_KV_TOL,
              f"split cache {path}")
        if state:
            mamba += 1
            for name, leaf in (("port", t_leaf.numpy()), ("reference",
                                                          j_leaf)):
                _within(leaf, w_leaf.numpy(), smoke.MAMBA_STATE_TOL,
                        f"{name} split against whole prefill, {path}")
    pattern, _, tail = stack_layout(tcfg)         # stacked leaves: a leaf
    assert mamba == 2 * [k for k, _ in pattern + tail].count("mamba")
    for name, logits in (("port", ts.numpy()), ("reference", js)):
        _within(logits[:, :tcfg.vocab], tw.numpy()[:, :tcfg.vocab],
                smoke.MAMBA_LOGIT_TOL, f"{name} split logits")


def test_phase_21_configurations_fit_the_card():
    """Weights and a ``FAMILY_BATCH`` × ``max_seq`` cache at each
    family's dtype, counted on ``meta``, under 80 GB; the sizes phase 21
    names; jamba's published 72 layers do not fit, its 4-layer cut keeps
    mamba, mamba + MoE, mamba and attention + MoE."""
    sizes = {}
    for fam in smoke.FAMILIES:
        cfg = smoke.family_config(fam)
        full = get_config(fam["arch"])
        assert dataclasses.replace(cfg, n_layers=full.n_layers) == full
        need = smoke.family_bytes(fam)
        n = param_count(model_defs(cfg))
        assert need["weights"] == n * (4 if fam["dtype"] == torch.float32
                                       else 2)
        assert 0 < need["cache"] < need["weights"]
        assert need["weights"] + need["cache"] < smoke.CARD_BYTES
        sizes[fam["arch"]] = n
    assert {a: round(n / 1e9, 2) for a, n in sizes.items()} == {
        "gemma3-1b": 1.0, "whisper-base": 0.1, "internvl2-26b": 19.86,
        "jamba-1.5-large-398b": 23.02}
    jamba = next(f for f in smoke.FAMILIES
                 if f["arch"] == "jamba-1.5-large-398b")
    cut = smoke.family_config(jamba)
    assert cut.n_layers == 4
    assert cut.layer_schedule() == ("mamba", "mamba", "mamba", "attn")
    assert cut.moe_layers() == (False, True, False, True)
    whole = get_config("jamba-1.5-large-398b")
    assert 2 * param_count(model_defs(whole)) > smoke.CARD_BYTES
    assert set(whole.layer_schedule()) == set(cut.layer_schedule())


def test_stacked_leaves_draw_at_the_repeat_count_as_the_reference():
    """Reference fault (ROADMAP Queue 3): ``init_params`` takes a leaf's
    fan-in from its first dim, which for a stacked leaf is the repeats
    axis, so a stacked weight is drawn at 1/√repeats, not 1/√fan-in.  The
    port copies it (its tests hold it to the reference's numbers): gemma3
    smoke's stacked ``wq`` (2 repeats of 64 × 128) has std ~1/√2 in both
    packages, its unstacked tail's ~1/√64."""
    from repro.models import params as jax_params
    from repro_torch.configs import get_smoke
    from repro_torch.models.params import init_params
    jcfg = jax_smoke("gemma3-1b")
    jp = jax_params.init_params(jax_tr.model_defs(jcfg),
                                jax.random.PRNGKey(0), jnp.float32)
    tp = init_params(model_defs(get_smoke("gemma3-1b")), seed=0,
                     dtype=torch.float32, device="cpu")
    stacked = (np.asarray(jp["blocks"][0]["mix"]["wq"]),
               tp["blocks"][0]["mix"]["wq"].numpy())
    tail = (np.asarray(jp["tail"][0]["mix"]["wq"]),
            tp["tail"][0]["mix"]["wq"].numpy())
    assert stacked[0].shape == stacked[1].shape == (2, 64, 128)
    for w in stacked:
        assert abs(float(w.std()) * np.sqrt(2) - 1) < 0.02
    for w in tail:
        assert abs(float(w.std()) * np.sqrt(64) - 1) < 0.03


def test_phase_22_configurations_fit_the_card():
    """Phase 22's three families (``BIG_FAMILIES``): the published
    configuration cut in depth only, weights and a ``FAMILY_BATCH`` ×
    ``max_seq`` cache at the family's dtype under 80 GB (counted on
    ``meta``) at the sizes phase 22 names; the published depth of each
    does not fit."""
    sizes = {}
    for fam in smoke.BIG_FAMILIES:
        cfg = smoke.family_config(fam)
        full = get_config(fam["arch"])
        assert dataclasses.replace(cfg, n_layers=full.n_layers) == full
        need = smoke.family_bytes(fam)
        elt = 4 if fam["dtype"] == torch.float32 else 2
        n = param_count(model_defs(cfg))
        assert need["weights"] == elt * n
        assert 0 < need["cache"] < need["weights"]
        assert need["weights"] + need["cache"] < smoke.CARD_BYTES
        assert elt * param_count(model_defs(full)) > smoke.CARD_BYTES
        sizes[fam["arch"]] = (cfg.n_layers, round(need["weights"] / 1e9, 2),
                              round(need["cache"] / 1e9, 2))
    assert sizes == {"mixtral-8x22b": (4, 20.84, 0.27),
                     "nemotron-4-340b": (1, 51.56, 0.06),
                     "qwen1.5-110b": (8, 26.73, 0.17)}
    nem = get_config("nemotron-4-340b")
    assert 2 * nem.vocab * nem.d_model == 9_437_184_000


def test_phase_22_mixtral_cut_and_prompts():
    """mixtral-8x22b's 4-layer cut keeps sliding-window attention and MoE
    on every layer, as all 56 have; its 8 prompts lie in 3,968–4,480 with
    at least two past the 4,096 window, so the ring wraps at prefill; the
    cache's ``max_seq`` holds the longest prompt and its 16 tokens; the
    windowed prefill timed alone is at the longest prompt."""
    fam = smoke.BIG_FAMILIES[0]
    cut, full = smoke.family_config(fam), get_config(fam["arch"])
    assert cut.n_layers == 4 and cut.local_window == 4096
    assert set(cut.layer_schedule()) == set(full.layer_schedule()) \
        == {"attn_swa"}
    assert all(cut.moe_layers()) and all(full.moe_layers())
    assert (cut.moe.n_experts, cut.moe.top_k) == (8, 2)
    lengths = [len(p) for p in smoke.family_prompts(fam, cut)]
    assert len(lengths) == 8 and min(lengths) >= 3968 \
        and max(lengths) <= 4480
    assert sum(n > cut.local_window for n in lengths) >= 2
    assert max(lengths) + smoke.FAMILY_NEW <= fam["max_seq"]
    calls = {c["name"]: c for c in smoke.big_family_calls()}
    prefill = calls["mixtral-8x22b windowed prefill"]
    assert prefill["shape"] == (4, 48, 8, max(lengths), max(lengths), 128)
    assert prefill["window"] == 4096
    assert calls["mixtral-8x22b ring decode"]["shape"][4] == 4096
    assert calls["nemotron-4-340b decode"]["shape"] == (4, 96, 8, 1, 1280,
                                                        192)
    qwen = smoke.BIG_FAMILIES[2]
    assert [t.shape for t, _ in smoke.family_prompts(
        qwen, smoke.family_config(qwen))] == [(4, 768), (4, 1024)]


def test_phase_22_family_calls_are_the_servers(monkeypatch):
    """``family_calls`` and ``planned_launches`` for mixtral smoke (window
    8) served through ``Server`` with prompts that cross the window: the
    calls the port's CPU serve makes on the kernel's branch of
    ``layers.attention`` (``attention_ref`` standing in for the launch),
    shape and masks, in order, and their plans' launches."""
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import Request, Server
    from repro_torch.models import layers
    from repro_torch.models.params import init_params
    cfg = get_smoke("mixtral-8x22b")
    assert cfg.local_window == 8
    seen = []

    def fake(q, k, v, *, causal=True, window=None, q_offset=0, backend):
        seen.append(((q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                      k.shape[2], q.shape[3]),
                     dict(causal=causal, window=window, q_offset=q_offset)))
        return tref.attention_ref(q, k, v, causal=causal, window=window,
                                  q_offset=q_offset)

    for module in (layers, port_engine):
        monkeypatch.setattr(module, "uses_kernel",
                            lambda x: not layers.plain_mode())
    monkeypatch.setattr(ops, "attention", fake)
    params = init_params(model_defs(cfg), seed=0, dtype=torch.float32,
                         device="cpu")
    max_seq, new = 32, 6
    server = Server(cfg, params, batch_size=smoke.FAMILY_BATCH,
                    max_seq=max_seq, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(5)
    lengths = (12, 15, 17, 20)
    for rid, n in enumerate(lengths):
        server.submit(Request(rid, rng.integers(0, cfg.vocab, n).astype(
            np.int32), new))
    results = server.run()
    assert sorted(results) == [0, 1, 2, 3]
    s_all = max(lengths)
    want = smoke.family_calls(fa, cfg, smoke.FAMILY_BATCH, s_all, max_seq,
                              range(s_all, s_all + new - 1))
    norm = lambda kw: dict(dict(window=None, q_offset=0), **kw)
    assert [(s, norm(kw)) for s, kw in want] == seen
    decodes = [kw for s, kw in seen if s[3] == 1]
    assert decodes[0] == dict(causal=False, window=None, q_offset=0)
    sms = 132
    assert smoke.planned_launches(fa, want, torch.bfloat16, sms) == sum(
        fa.plan(*s, torch.bfloat16, **kw, sm_count=sms).launches
        for s, kw in seen)


def test_phase_23_state_bytes_under_the_depth_rule():
    """Phase 23's training state (float32 parameters and one microbatch's
    float32 gradients, the bf16 accumulator, two int8 moments with their
    block scales), reckoned on ``meta``: 1 layer (2.91 B parameters)
    about 35 GB, 2 layers (5.41 B) about 65 GB, under the depth rule's
    72 GB, 3 layers over it; the rule takes 2 layers only where the dry
    run's 2-layer peak is under 72 GB."""
    state = {n: smoke.big_train_state_bytes(n) for n in (1, 2, 3)}
    assert [round(state[n]["params"] / 1e9, 2) for n in (1, 2)] \
        == [2.91, 5.41]
    for n, st in state.items():
        p = st["params"]
        assert (st["parameters"], st["gradients"], st["accumulator"]) == (
            4 * p, 4 * p, 2 * p)
        assert 2 * p < st["moments"] < 2.1 * p
        assert st["total"] == sum(st[k] for k in (
            "parameters", "gradients", "accumulator", "moments"))
    assert [round(state[n]["total"] / 1e9) for n in (1, 2)] == [35, 65]
    assert state[2]["total"] < smoke.BIG_TRAIN_PEAK_LIMIT \
        < state[3]["total"]
    rule = lambda peak: smoke.big_train_depth(
        {1: {"predicted_peak_bytes": 0}, 2: {"predicted_peak_bytes": peak}})
    assert rule(state[2]["total"] + 5e9) == 2
    assert rule(smoke.BIG_TRAIN_PEAK_LIMIT) == 1


def test_phase_23_dry_run_and_update_check_at_smoke_size(tmp_path):
    """Phase 23's pieces on mixtral smoke: ``big_train_meta`` (its own
    process, a fake group) traces the recipe's step at 1 and 2 layers,
    each peak at least the state the step holds; ``eightbit_update_check``
    with both sides on the CPU finds every leaf equal (the router's 4
    experts, a padded 256-block)."""
    import subprocess
    import sys
    from repro_torch.configs import get_smoke
    from repro_torch.launch.train import default_train_config
    from repro_torch.models.params import (abstract_params, init_params,
                                           tensors)
    from repro_torch.optim.adamw import scale_blocks
    from repro_torch.train.train_step import make_grad_fn
    out = tmp_path / "meta.pt"
    code = ("import dataclasses, sys; sys.path.insert(0, 'src'); "
            "import chip_smoke; from repro_torch.configs import get_smoke; "
            "chip_smoke.big_train_meta(sys.argv[1], cfg_of=lambda n: "
            "dataclasses.replace(get_smoke('mixtral-8x22b'), n_layers=n), "
            "seq_len=32)")
    proc = subprocess.run([sys.executable, "-c", code, str(out)], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    meta = torch.load(out, weights_only=False)
    base = get_smoke("mixtral-8x22b")
    for n in (1, 2):
        cfg = dataclasses.replace(base, n_layers=n)
        leaves = tensors(abstract_params(model_defs(cfg), torch.float32))
        p = sum(t.numel() for t in leaves)
        scales = sum(int(np.prod(t.shape[:-1])) * scale_blocks(t.shape[-1])
                     for t in leaves)
        held = 4 * p + 2 * p + 8 * scales            # parameters, moments
        assert meta[n]["local_arg_bytes"] >= held
        assert meta[n]["peak_temp_bytes"] >= 4 * p + 2 * p   # grads, acc
        assert meta[n]["predicted_peak_bytes"] == (
            meta[n]["local_arg_bytes"] + meta[n]["peak_temp_bytes"])
    assert meta[2]["predicted_peak_bytes"] > meta[1]["predicted_peak_bytes"]

    cfg = dataclasses.replace(base, n_layers=2)
    tc = default_train_config("mixtral-8x22b", smoke.BIG_TRAIN_BATCH, 3)
    params = init_params(smoke.fan_in_defs(model_defs(cfg)), seed=0,
                         dtype=torch.float32, device="cpu")
    for t in tensors(params):
        t.requires_grad_(True)
    rng = np.random.default_rng(3)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (8, 16)))
             for k in ("tokens", "labels")}
    _, _, grads = make_grad_fn(cfg, tc)(params, batch)
    got = smoke.eightbit_update_check(tc.opt, params, grads)()
    assert got["failures"] == [] and len(got["rounds"]) == 2
    for row in got["rounds"]:
        assert row["grad_norm_rel"] == 0
        for leaf in row["leaves"].values():
            assert leaf["mu codes"]["differing"] == 0
            assert leaf["param"]["equal_share"] == 1.0
    router = got["rounds"][0]["leaves"]["blocks/0/ffn/router"]
    assert router["elements"] == 2 * cfg.d_model * cfg.moe.n_experts
