"""GLM-4-9B [hf:THUDM/glm-4-9b]: dense, RoPE, GQA with 2 KV heads, QKV
bias.

Port of ``repro/configs/glm4_9b.py``: 40 layers, d_model 4096, 32 heads of
128 over 2 KV heads, SwiGLU d_ff 13,696, RMSNorm, untied embeddings, vocab
151,552; 9,399,951,360 parameters by shape.  Its decode attention is the
``swa_decode`` kernel at REP 16 (two groups of 8 query heads a KV head),
Dh 128.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="glm4-9b", arch_type="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab_size=151_552,
    qkv_bias=True, mlp="swiglu", norm="rmsnorm",
    fsdp=True,
    source="hf:THUDM/glm-4-9b",
)


def smoke() -> ArchConfig:
    """Tiny same-family variant for tests (``glm4-9b-smoke``)."""
    return dataclasses.replace(
        CONFIG, name="glm4-9b-smoke", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab_size=512, fsdp=False, remat=False,
        attn_q_chunk=64)
