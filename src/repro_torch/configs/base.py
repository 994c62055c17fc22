"""ArchConfig: one dataclass describing every supported architecture.

Port of ``repro/configs/base.py``.  The fields and their defaults are the
reference's; ``dtype`` is a torch dtype (bf16 by default, as there).  Only
the dense path is wired in this port so far, but the dataclass keeps every
field so a config carries over unchanged.
"""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    arch_type: str                # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int                  # 0 => attention-free
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0             # 0 => d_model // n_heads
    mlp: str = "swiglu"           # swiglu | gelu (non-gated) | geglu
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    use_rope: bool = True
    tie_embeddings: bool = False
    max_position: int = 131_072
    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 0
    d_expert: int = 0
    moe_capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 128
    # --- hybrid (zamba2) ---
    attn_every: int = 0
    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500
    # --- modality frontend stub ---
    n_prefix_tokens: int = 0
    # --- long-context decode ---
    window: int = 4096
    # --- systems knobs (the sharding/remat ones have no effect in the port)
    fsdp: bool = False
    optimizer: str = "adamw"
    remat: bool = True
    attn_q_chunk: int = 512       # query-chunked attention block size
    loss_chunk: int = 1024        # sequence-chunked cross-entropy block
    attn_remat_chunks: bool = True
    attn_seq_shard: bool = True
    dtype: torch.dtype = torch.bfloat16
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def d_exp(self) -> int:
        return self.d_expert or self.d_ff

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 (the reference's layout)."""
        return math.ceil(self.vocab_size / 256) * 256
