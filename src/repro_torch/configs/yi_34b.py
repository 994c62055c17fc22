"""Yi-34B [arXiv:2403.04652]: a llama-architecture dense model, GQA with 8
KV heads.

Port of ``repro/configs/yi_34b.py``: 60 layers, d_model 7168, 56 heads of
128 over 8 KV heads, SwiGLU d_ff 20,480, RMSNorm, vocab 64,000;
34,388,917,248 parameters by shape (68.8 GB in bf16; each MLP leaf holds
60 x 7168 x 20480 = 8,808,038,400 elements, past 2**31).  Its decode
attention is the ``swa_decode`` kernel at REP 7, Dh 128.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b", arch_type="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20_480, vocab_size=64_000,
    mlp="swiglu", norm="rmsnorm",
    fsdp=True,
    source="arXiv:2403.04652",
)


def smoke() -> ArchConfig:
    """Tiny same-family variant for tests (``yi-34b-smoke``)."""
    return dataclasses.replace(
        CONFIG, name="yi-34b-smoke", n_layers=2, d_model=256, n_heads=8,
        n_kv_heads=2, d_ff=512, vocab_size=512, fsdp=False, remat=False,
        attn_q_chunk=64)
