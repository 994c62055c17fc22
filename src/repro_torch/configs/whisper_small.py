"""Whisper-small [arXiv:2212.04356]: an encoder-decoder audio model.

Port of ``repro/configs/whisper_small.py``: 12 non-causal encoder blocks
over 1,500 frames and 12 decoder blocks with cross-attention (d_model 768,
12 heads of 64, a GELU MLP of 3072 with biases, LayerNorm with bias, no
RoPE: learned ``enc_pos`` and ``dec_pos``), vocab 51,865; 304,508,928
parameters by shape.  The conv frontend is a stub, as in the reference:
1,500 precomputed frame embeddings (B, 1500, 768) feed the encoder.  Its
decode attention is the ``swa_decode`` kernel at REP 1, Dh 64: over the
self-attention cache and over the 1,500-slot cross-attention cache.
"""
import dataclasses

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", arch_type="audio",
    n_layers=12, encoder_layers=12, encoder_seq=1500,
    d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51_865,
    mlp="gelu", norm="layernorm", use_rope=False,
    max_position=32_768,     # mechanical decode-32k support; whisper's own
                             # decoder ceiling is 448 tokens
    source="arXiv:2212.04356",
)


def smoke() -> ArchConfig:
    """Tiny same-family variant for tests (``whisper-small-smoke``)."""
    return dataclasses.replace(
        CONFIG, name="whisper-small-smoke", n_layers=2, encoder_layers=2,
        encoder_seq=64, d_model=128, n_heads=4, n_kv_heads=4, d_ff=256,
        vocab_size=512, max_position=256, remat=False, attn_q_chunk=64)
