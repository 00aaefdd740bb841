"""rwkv6-7b [ssm] — RWKV-6 "Finch", attention-free, data-dependent decay
(arXiv:2404.05892).

32L, d_model=4096, d_ff=14336, vocab=65536; 64 WKV heads of dim 64.
Attention-free: the paper's GEMM lowering applies to every projection but
NOT to the WKV recurrence (DESIGN.md §Arch-applicability).  ``long_500k``
runs with O(1) state.
"""

from repro_torch.models.config import ModelConfig


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b", n_layers=32, d_model=4096, n_heads=64,
        n_kv_heads=64, d_ff=14336, vocab=65536, ssm_kind="rwkv6",
        rwkv_head_dim=64, remat="full", causal_skip=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-smoke", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=192, vocab=512, ssm_kind="rwkv6",
        rwkv_head_dim=16, q_chunk=16, kv_chunk=16, remat="none",
    )
