"""Zamba2-1.2B [arXiv:2411.15242]: a Mamba2 backbone with ONE shared
attention + MLP block applied before every 6 SSD blocks.

Port of ``repro/configs/zamba2_1_2b.py``: 38 SSD blocks (d_model 2048,
d_inner 4096 in 64 heads of 64, state 64), the shared block with 32 heads
of 64 (no GQA) and a SwiGLU MLP of 8192, applied at 7 sites, each with its
own K/V cache at decode; vocab 32,000; 1,170,473,856 parameters by shape.
Its decode attention is the ``swa_decode`` kernel at REP 1, Dh 64.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-1.2b", arch_type="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32_000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    attn_every=6,
    mlp="swiglu", norm="rmsnorm",
    source="arXiv:2411.15242",
)


def smoke() -> ArchConfig:
    """Tiny same-family variant for tests (``zamba2-smoke``)."""
    return dataclasses.replace(
        CONFIG, name="zamba2-smoke", n_layers=4, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=256, ssm_state=16, ssm_head_dim=32, ssm_chunk=16,
        attn_every=2, vocab_size=512, remat=False, attn_q_chunk=64)
