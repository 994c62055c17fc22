"""StarCoder2-7B [arXiv:2402.19173]: dense GQA with 4 KV heads, RoPE,
LayerNorm, a non-gated GELU MLP, attention bias.

Port of ``repro/configs/starcoder2_7b.py``: 32 layers, d_model 4608, 36
heads of 128 over 4 KV heads, QKV bias, LayerNorm with bias, the tanh GELU
MLP of 18,432 with biases, vocab 49,152; 7,400,268,800 parameters by
shape.  Its decode attention is the ``swa_decode`` kernel at REP 9 (a
group of 8 query heads and a group of 1 a KV head), Dh 128.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b", arch_type="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18_432, vocab_size=49_152,
    qkv_bias=True, mlp="gelu", norm="layernorm",
    fsdp=True,
    source="arXiv:2402.19173",
)


def smoke() -> ArchConfig:
    """Tiny same-family variant for tests (``starcoder2-smoke``)."""
    return dataclasses.replace(
        CONFIG, name="starcoder2-smoke", n_layers=2, d_model=256, n_heads=4,
        n_kv_heads=2, d_ff=512, vocab_size=512, fsdp=False, remat=False,
        attn_q_chunk=64)
