"""Grok-1-314B [hf:xai-org/grok-1]: MoE with 8 GeGLU experts, top-2, GQA
with 8 KV heads.

Port of ``repro/configs/grok1_314b.py``: 64 layers, d_model 6144, 48 heads
of 128 over 8 KV heads, in every block a MoE of 8 gated-GELU experts of
32,768 (top-2, capacity factor 1.25), RMSNorm, vocab 131,072;
316,489,340,928 parameters by shape (a block 4,919,980,032; the
embedding, head and final norm 1,610,618,880), far past one card's 80 GB:
the card serves it at 2 of its 64 layers (11,450,578,944).  Its optimizer is
SGD-momentum with a moment in the parameters' dtype.  Its decode attention
is the ``swa_decode`` kernel at REP 6, Dh 128.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", arch_type="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32_768, vocab_size=131_072,
    n_experts=8, experts_per_tok=2, d_expert=32_768,
    mlp="geglu", norm="rmsnorm",
    fsdp=True, optimizer="sgdm",
    source="hf:xai-org/grok-1",
)


def smoke() -> ArchConfig:
    """Tiny same-family variant for tests (``grok1-smoke``)."""
    return dataclasses.replace(
        CONFIG, name="grok1-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, d_expert=256, vocab_size=512,
        n_experts=4, experts_per_tok=2, fsdp=False, remat=False,
        attn_q_chunk=64)
