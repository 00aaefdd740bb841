"""whisper-base [audio] — enc-dec, conv frontend STUB (arXiv:2212.04356).

6L decoder (and 6L encoder), d_model=512, 8H (kv=8 ⇒ MHA), d_ff=2048,
vocab=51865.  The audio conv frontend is a stub per the assignment:
``input_specs`` feeds precomputed (B, 1500, 512) frame embeddings to the
encoder.  Whisper's learned absolute positions are kept on the encoder;
the decoder uses RoPE (adaptation note in DESIGN.md — shape-identical).
Decoder seq 4k/32k exceeds Whisper's trained 448 positions; shapes are the
assignment's and exercise the lowering, not the pretrained weights.
"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="whisper-base", n_layers=6, d_model=512, n_heads=8,
        n_kv_heads=8, d_ff=2048, vocab=51865, act="gelu", norm="layernorm",
        encoder_layers=6, encoder_seq=1500, frontend="audio",
        remat="full", causal_skip=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-base-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=128, vocab=256, act="gelu", norm="layernorm",
        encoder_layers=2, encoder_seq=24, frontend="audio",
        q_chunk=16, kv_chunk=16, remat="none",
    )
