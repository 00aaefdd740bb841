"""nemotron-4-340b [dense] — GQA + squared-ReLU (arXiv:2402.16819).

96L, d_model=18432, 96H (kv=8), d_ff=73728, vocab=256000.  head_dim=192.
"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-340b", n_layers=96, d_model=18432, n_heads=96,
        n_kv_heads=8, d_ff=73728, vocab=256000, act="sq_relu",
        remat="full", causal_skip=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="nemotron-smoke", n_layers=3, d_model=96, n_heads=6,
        n_kv_heads=2, d_ff=384, vocab=512, act="sq_relu",
        q_chunk=16, kv_chunk=16, remat="none",
    )
