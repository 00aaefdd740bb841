"""Unified architecture configuration covering all 10 assigned archs.

One ``ModelConfig`` describes dense transformers, GQA/MQA variants, MoE,
RWKV-6, Mamba hybrids, encoder-decoder (whisper) and stub-fronted VLM/audio
models.  Per-layer behaviour comes from ``layer_schedule()`` which expands
the declarative schedule fields into a per-layer kind list.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    # apply MoE every `period` layers (jamba: 2 → alternate dense/MoE)
    period: int = 1
    n_shared_experts: int = 0


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # default d_model // n_heads

    # layer schedule
    attn_kind: str = "global"             # global | local_global | swa
    local_window: int = 1024              # window for local / swa layers
    local_ratio: int = 0                  # gemma3: N local per 1 global
    ssm_kind: Optional[str] = None        # None | "rwkv6" | "mamba"
    ssm_ratio: int = 0                    # jamba: N ssm per 1 attn

    # blocks
    act: str = "swiglu"                   # swiglu | geglu | sq_relu | gelu
    norm: str = "rmsnorm"                 # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_theta_global: Optional[float] = None   # gemma3: 1e6 on global layers
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None

    # mamba (hybrid) geometry
    mamba_d_state: int = 16
    mamba_expand: int = 2
    mamba_conv: int = 4

    # rwkv geometry
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    encoder_layers: int = 0               # 0 → decoder-only
    encoder_seq: int = 1500               # precomputed frame embeddings

    # modality frontends (STUB per assignment: precomputed embeddings)
    frontend: Optional[str] = None        # None | "audio" | "vision"
    frontend_prefix: int = 0              # patch/frame prefix length in seq

    # execution policy
    remat: str = "full"                   # none | dots | full
    scan_layers: bool = True              # lax.scan over layer stack
    q_chunk: int = 512
    kv_chunk: int = 512
    causal_skip: bool = False             # §Perf: skip fully-masked kv chunks

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % self.n_kv_heads == 0

    @property
    def vocab_padded(self) -> int:
        """Embedding-table size: vocab rounded up to a 256 multiple so the
        vocab axis shards evenly over any production mesh (whisper's 51865
        and internvl's 92553 are not 16-divisible).  Logits beyond
        ``vocab`` are masked in ``unembed_logits``."""
        return ((self.vocab + 255) // 256) * 256

    # ------------------------------------------------------------------
    def layer_schedule(self) -> Tuple[str, ...]:
        """Per-layer kinds: 'attn' | 'attn_local' | 'attn_swa' | 'rwkv6'
        | 'mamba' (decoder stack)."""
        kinds = []
        for i in range(self.n_layers):
            if self.ssm_kind and self.ssm_ratio:
                # jamba: 1 attn per (ssm_ratio+1) layers, attn in the middle
                pos = i % (self.ssm_ratio + 1)
                if pos == self.ssm_ratio // 2:
                    kinds.append("attn")
                else:
                    kinds.append(self.ssm_kind)
            elif self.ssm_kind:
                kinds.append(self.ssm_kind)
            elif self.attn_kind == "swa":
                kinds.append("attn_swa")
            elif self.attn_kind == "local_global" and self.local_ratio:
                # gemma3: `local_ratio` local layers then 1 global
                kinds.append("attn_local"
                             if (i % (self.local_ratio + 1)) < self.local_ratio
                             else "attn")
            else:
                kinds.append("attn")
        return tuple(kinds)

    def moe_layers(self) -> Tuple[bool, ...]:
        if self.moe is None:
            return tuple(False for _ in range(self.n_layers))
        return tuple((i % self.moe.period) == self.moe.period - 1
                     for i in range(self.n_layers))

    @property
    def uniform_stack(self) -> bool:
        """True when every decoder layer is identical (enables scan-over-
        layers with stacked params)."""
        return (len(set(self.layer_schedule())) == 1
                and len(set(self.moe_layers())) == 1)

    # ------------------------------------------------------------------
    def param_count_estimate(self) -> int:
        """Analytic parameter count (embeddings + layers), for 6·N·D."""
        d, v = self.d_model, self.vocab
        hd = self.head_dim
        total = v * d * (1 if self.tie_embeddings else 2)
        sched = self.layer_schedule()
        moe_layers = self.moe_layers()
        for kind, is_moe in zip(sched, moe_layers):
            if kind.startswith("attn"):
                total += d * (self.n_heads * hd) + d * (2 * self.n_kv_heads * hd)
                total += self.n_heads * hd * d
            elif kind == "mamba":
                di = self.mamba_expand * d
                total += 2 * d * di + di * d + di * (2 * self.mamba_d_state + 1)
                total += di * self.mamba_conv
            elif kind == "rwkv6":
                total += 4 * d * d + d * d          # r,k,v,g,o
                total += 2 * d * self.d_ff          # channel mix
                continue                            # no separate FFN
            if is_moe and self.moe is not None:
                n_ff = 3 if self.act in ("swiglu", "geglu") else 2
                total += (self.moe.n_experts *
                          n_ff * d * self.moe.d_ff_expert)
                total += d * self.moe.n_experts     # router
            else:
                n_ff = 3 if self.act in ("swiglu", "geglu") else 2
                total += n_ff * d * self.d_ff
        if self.encoder_layers:
            # encoder self-attn + FFN, decoder cross-attn
            enc = self.encoder_layers * (
                4 * d * self.n_heads * hd + 2 * d * self.d_ff)
            cross = self.n_layers * (4 * d * self.n_heads * hd)
            total += enc + cross
        return total

    def active_param_count_estimate(self) -> int:
        """MoE: experts scaled by top_k/n_experts (for 6·N_active·D)."""
        if self.moe is None:
            return self.param_count_estimate()
        dense = dataclasses.replace(self, moe=None)
        base = dense.param_count_estimate()
        n_ff = 3 if self.act in ("swiglu", "geglu") else 2
        dense_ffn = sum(n_ff * self.d_model * self.d_ff
                        for m in self.moe_layers() if not m)
        # subtract the dense FFNs counted for MoE layers, add active experts
        moe_count = sum(1 for m in self.moe_layers() if m)
        base -= moe_count * n_ff * self.d_model * self.d_ff
        base += moe_count * (self.moe.top_k + self.moe.n_shared_experts) \
            * n_ff * self.d_model * self.moe.d_ff_expert
        return base
