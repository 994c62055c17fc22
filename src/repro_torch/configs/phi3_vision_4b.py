"""Phi-3-vision-4.2B [hf:microsoft/Phi-3-vision-128k-instruct]: the
phi3-mini backbone behind a CLIP frontend.

Port of ``repro/configs/phi3_vision_4b.py``: 32 dense blocks (d_model
3072, 32 heads of 96, no GQA, a SwiGLU MLP of 8192, RMSNorm, RoPE), vocab
32,064; 3,825,404,928 parameters by shape.  The vision encoder is a stub,
as in the reference: 576 precomputed patch embeddings (B, 576, 1024) go
through the learned ``vis_proj`` (1024, 3072) and are prepended to the
tokens.  Its decode attention is the ``swa_decode`` kernel at REP 1,
Dh 96.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b", arch_type="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_064,
    n_prefix_tokens=576,                       # CLIP ViT-L/14 @ 336px
    mlp="swiglu", norm="rmsnorm",
    fsdp=True,
    source="hf:microsoft/Phi-3-vision-128k-instruct",
)


def smoke() -> ArchConfig:
    """Tiny same-family variant for tests (``phi3v-smoke``)."""
    return dataclasses.replace(
        CONFIG, name="phi3v-smoke", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=4, d_ff=512, vocab_size=512, n_prefix_tokens=16,
        fsdp=False, remat=False, attn_q_chunk=64)
