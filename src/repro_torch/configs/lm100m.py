"""~100M-parameter decoder-only LM for the end-to-end training example
(examples/train_lm.py): 14L, d_model=640, 10H (kv=2), d_ff=2560,
vocab=4096 ⇒ ≈ 96M params."""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="lm100m", n_layers=14, d_model=640, n_heads=10, n_kv_heads=2,
        d_ff=2560, vocab=4096, act="swiglu", q_chunk=256, kv_chunk=256,
        remat="dots",
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="lm100m-smoke", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512, act="swiglu", q_chunk=16, kv_chunk=16,
        remat="none",
    )
