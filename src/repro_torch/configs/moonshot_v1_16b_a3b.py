"""moonshot-v1-16b-a3b [moe] — Moonlight-16B-A3B-style MoE
(hf:moonshotai/Moonlight-16B-A3B).

48L, d_model=2048, 16H (kv=16 ⇒ MHA), expert d_ff=1408, vocab=163840,
MoE 64 experts top-6 on every layer.  (Moonlight also carries shared
experts; the assignment lists 64e top-6 only, so shared experts stay off —
noted in DESIGN.md.)
"""

from repro_torch.models.config import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1408, vocab=163840, act="swiglu",
        moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408),
        remat="full", causal_skip=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=96, vocab=512, act="swiglu",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=96),
        q_chunk=16, kv_chunk=16, remat="none",
    )
