"""qwen2.5-3b [dense] — GQA + QKV bias (hf:Qwen/Qwen2.5).

36L, d_model=2048, 16H (kv=2), d_ff=11008, vocab=151936.  The QKV bias is
the paper's ``C = A·B + X`` accumulator-preload form on the VTA side.
"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", n_layers=36, d_model=2048, n_heads=16,
        n_kv_heads=2, d_ff=11008, vocab=151936, act="swiglu", qkv_bias=True,
        rope_theta=1e6, remat="full", causal_skip=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=160, vocab=512, act="swiglu", qkv_bias=True,
        q_chunk=16, kv_chunk=16, remat="none",
    )
