"""Mamba2-370m [arXiv:2405.21060]: attention-free SSD (state-space
duality).

Port of ``repro/configs/mamba2_370m.py``: 48 SSD blocks, d_model 1024,
d_inner 2048 in 32 heads of 64, state 128, conv 4, chunk 128, an untied
head over vocab 50,280 (padded to 50,432); 420,136,448 parameters by
shape.  It decodes with its O(1) recurrent state and no attention.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", arch_type="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50_280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=128,
    use_rope=False, norm="rmsnorm",
    source="arXiv:2405.21060",
)


def smoke() -> ArchConfig:
    """Tiny same-family variant for tests (``mamba2-smoke``)."""
    return dataclasses.replace(
        CONFIG, name="mamba2-smoke", n_layers=2, d_model=128, ssm_state=16,
        ssm_head_dim=32, ssm_chunk=16, vocab_size=512, remat=False)
