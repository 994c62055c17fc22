"""OLMoE-1B-7B [arXiv:2409.02060]: 64 experts, top-8, d_expert 1024.

Port of ``repro/configs/olmoe_1b_7b.py``: 16 layers, d_model 2048, 16
heads of 128 (no GQA), a SwiGLU MoE in every block, vocab 50,304;
6,919,620,608 parameters by shape.  Its decode attention is the
``swa_decode`` kernel at REP 1, Dh 128.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", arch_type="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50_304,
    n_experts=64, experts_per_tok=8, d_expert=1024,
    mlp="swiglu", norm="rmsnorm",
    source="arXiv:2409.02060",
)


def smoke() -> ArchConfig:
    """Tiny same-family variant for tests (``olmoe-smoke``)."""
    return dataclasses.replace(
        CONFIG, name="olmoe-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=4, d_ff=128, d_expert=128, vocab_size=512,
        n_experts=4, experts_per_tok=2, remat=False, attn_q_chunk=64)
