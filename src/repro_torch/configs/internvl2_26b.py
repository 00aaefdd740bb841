"""internvl2-26b [vlm] — InternViT frontend STUB + InternLM2-20B backbone
(arXiv:2404.16821).

LM backbone: 48L, d_model=6144, 48H (kv=8), d_ff=16384, vocab=92553.
The vision tower is a stub per the assignment: ``input_specs`` provides a
(B, 256, 6144) precomputed patch-embedding prefix; sequence shapes count
the prefix inside seq_len.
"""

from repro_torch.models.config import ModelConfig

VISION_PREFIX = 256


def full() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", n_layers=48, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=16384, vocab=92553, act="swiglu",
        frontend="vision", frontend_prefix=VISION_PREFIX, remat="full", causal_skip=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="internvl2-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, act="swiglu",
        frontend="vision", frontend_prefix=8,
        q_chunk=16, kv_chunk=16, remat="none",
    )
