"""qwen1.5-110b [dense] — GQA + QKV bias (hf:Qwen/Qwen1.5).

80L, d_model=8192, 64H (kv=8), d_ff=49152, vocab=152064.
"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b", n_layers=80, d_model=8192, n_heads=64,
        n_kv_heads=8, d_ff=49152, vocab=152064, act="swiglu", qkv_bias=True,
        rope_theta=1e6, remat="full", causal_skip=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-smoke", n_layers=3, d_model=64, n_heads=8,
        n_kv_heads=2, d_ff=192, vocab=512, act="swiglu", qkv_bias=True,
        q_chunk=16, kv_chunk=16, remat="none",
    )
