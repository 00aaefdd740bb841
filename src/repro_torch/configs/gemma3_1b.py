"""gemma3-1b [dense] — 5:1 local:global attention, 128k context
(hf:google/gemma-3-1b-pt).

26L, d_model=1152, 4H (kv=1 ⇒ MQA), d_ff=6912, vocab=262144.
head_dim=256 (decoupled from d_model/n_heads, per the HF config).
Local layers: 512-token sliding window, RoPE θ=10k; global layers every
6th, RoPE θ=1M.  Tied embeddings.  ``long_500k`` runs: only the ~1/6
global layers hold full-length KV (sequence-sharded), local layers are
O(window).
"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-1b", n_layers=26, d_model=1152, n_heads=4,
        n_kv_heads=1, d_ff=6912, vocab=262144, head_dim=256,
        act="geglu", attn_kind="local_global", local_ratio=5,
        local_window=512, rope_theta=1e4, rope_theta_global=1e6,
        tie_embeddings=True, remat="full", causal_skip=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma3-smoke", n_layers=7, d_model=64, n_heads=4,
        n_kv_heads=1, d_ff=192, vocab=512, head_dim=32,
        act="geglu", attn_kind="local_global", local_ratio=2,
        local_window=8, rope_theta=1e4, rope_theta_global=1e6,
        tie_embeddings=True, q_chunk=16, kv_chunk=16, remat="none",
    )
