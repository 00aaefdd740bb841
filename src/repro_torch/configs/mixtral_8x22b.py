"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention
(arXiv:2401.04088).

56L, d_model=6144, 48H (kv=8), expert d_ff=16384, vocab=32768; SWA window
4096 per the assignment ⇒ ``long_500k`` runs with O(window) KV.
"""

from repro_torch.models.config import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", n_layers=56, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=16384, vocab=32768, act="swiglu",
        attn_kind="swa", local_window=4096,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=16384),
        remat="full", causal_skip=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="mixtral-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, act="swiglu",
        attn_kind="swa", local_window=8,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128),
        q_chunk=16, kv_chunk=16, remat="none",
    )
