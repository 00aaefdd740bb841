"""jamba-1.5-large-398b [hybrid] — Mamba + attention 7:1 interleave, MoE
16e top-2 (arXiv:2403.19887).

72L, d_model=8192, 64H (kv=8), d_ff=24576, vocab=65536.  Every 8-layer
period holds 7 Mamba layers + 1 attention layer; MoE every other layer.
``long_500k`` runs: only the 9 attention layers hold full-length KV
(sequence-sharded), Mamba layers are O(1) state.
"""

from repro_torch.models.config import ModelConfig, MoEConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", n_layers=72, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=24576, vocab=65536, act="swiglu",
        ssm_kind="mamba", ssm_ratio=7, mamba_d_state=16, mamba_expand=2,
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=24576, period=2),
        remat="full", causal_skip=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-smoke", n_layers=8, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, act="swiglu",
        ssm_kind="mamba", ssm_ratio=3, mamba_d_state=4, mamba_expand=2,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=128, period=2),
        q_chunk=16, kv_chunk=16, remat="none",
    )
