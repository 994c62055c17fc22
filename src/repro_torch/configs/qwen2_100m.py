"""Qwen2-family ~128M-parameter config for the federated 100M LGC stack.

Port of ``repro/configs/qwen2_100m.py``: 12 layers, d_model 768, 32k tied
vocab.  Eight of its leaves (embed and the seven stacked matmuls) are at or
above ``PALLAS_MIN_ELEMS`` and take the compression kernels.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-100m", arch_type="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
    d_ff=3072, vocab_size=32_000,
    qkv_bias=True, tie_embeddings=True,
    mlp="swiglu", norm="rmsnorm",
    remat=False, attn_q_chunk=128, loss_chunk=256,
    source="arXiv:2407.10671 (scaled)",
)


def smoke() -> ArchConfig:
    """Tiny same-shape variant for tests."""
    return dataclasses.replace(
        CONFIG, name="qwen2-100m-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab_size=512, attn_q_chunk=64,
        loss_chunk=64)
