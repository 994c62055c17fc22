"""Transformer primitives: RMSNorm, RoPE, GQA attention (train), SwiGLU MLP
and the initialisers.  Port of ``repro/models/layers.py:18-291``.

Conventions are the reference's:
  * activations (B, S, D); attention heads (B, S, H, hd)
  * weights are used as ``x @ W`` with W stored (in, out)
  * math in the config dtype (bf16), softmax and norm statistics in f32

``attention_train`` is plain jnp in the reference (no Pallas kernel), so it is
plain torch here.  The reference's remat and sequence-sharding knobs change
memory and layout, not values, and have no counterpart on one card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet "
                                  "(ROADMAP A15)")
    return rmsnorm(x, p["scale"])


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def rope_freqs(hd: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) or (S,) absolute positions."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs    # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, hd)


def qkv_project(x: torch.Tensor, p: dict, n_heads: int, n_kv: int, hd: int,
                bias: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (_split_heads(q, n_heads, hd), _split_heads(k, n_kv, hd),
            _split_heads(v, n_kv, hd))


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,S,Kv,hd) -> (B,S,H,hd) by repeating each kv head H/Kv times."""
    return torch.repeat_interleave(k, n_heads // k.shape[2], dim=2)


def attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    q_chunk: int = 512) -> torch.Tensor:
    """Query-chunked masked attention, as the reference computes it.

    q: (B,S,H,hd); k,v: (B,S,H,hd) (kv already expanded to H heads).
    Logits are taken in f32, masked to NEG_INF, softmaxed in f32 and cast
    to v's dtype before the value product.
    """
    b, s, h, hd = q.shape
    s_k = k.shape[1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                          device=q.device))
    qc = min(q_chunk, s)
    n_chunks = (s + qc - 1) // qc
    pad = n_chunks * qc - s
    if pad:
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
    kh = k.transpose(1, 2)                                  # (B,H,Sk,hd)
    vh = v.transpose(1, 2)
    kpos = torch.arange(s_k, device=q.device)
    outs = []
    for ci in range(n_chunks):
        qb = q[:, ci * qc:(ci + 1) * qc].transpose(1, 2)    # (B,H,qc,hd)
        logits = (qb @ kh.transpose(-1, -2)).to(torch.float32) * scale
        qpos = ci * qc + torch.arange(qc, device=q.device)
        mask = torch.ones((qc, s_k), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= kpos[None, :] > qpos[:, None] - window
        if causal or window:
            logits = torch.where(mask, logits,
                                 torch.full_like(logits, NEG_INF))
        p = torch.softmax(logits, -1).to(vh.dtype)
        outs.append((p @ vh).transpose(1, 2))               # (B,qc,H,hd)
    out = torch.cat(outs, 1) if n_chunks > 1 else outs[0]
    return out[:, :s] if pad else out


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_forward(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    if kind != "swiglu":
        raise NotImplementedError(f"mlp {kind!r} is not ported yet "
                                  "(ROADMAP A15)")
    return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


# ---------------------------------------------------------------------------
# initialisers: N(0, std) weights from an explicit generator; ``lead`` is
# the stacked-layer prefix of the shape, e.g. (n_layers,)
# ---------------------------------------------------------------------------

def normal(gen: torch.Generator | None, shape: tuple, std: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def mlp_init(gen, lead: tuple, d: int, dff: int, kind: str, dtype,
             device) -> dict:
    if kind != "swiglu":
        raise NotImplementedError(f"mlp {kind!r} is not ported yet "
                                  "(ROADMAP A15)")
    s_in, s_ff = d ** -0.5, dff ** -0.5
    return {
        "w_gate": normal(gen, lead + (d, dff), s_in, dtype, device),
        "w_up": normal(gen, lead + (d, dff), s_in, dtype, device),
        "w_down": normal(gen, lead + (dff, d), s_ff, dtype, device),
    }


def attn_init(gen, lead: tuple, d: int, n_heads: int, n_kv: int, hd: int,
              bias: bool, dtype, device) -> dict:
    s = d ** -0.5
    p = {
        "wq": normal(gen, lead + (d, n_heads * hd), s, dtype, device),
        "wk": normal(gen, lead + (d, n_kv * hd), s, dtype, device),
        "wv": normal(gen, lead + (d, n_kv * hd), s, dtype, device),
        "wo": normal(gen, lead + (n_heads * hd, d), (n_heads * hd) ** -0.5,
                     dtype, device),
    }
    if bias:
        p |= {"bq": torch.zeros(lead + (n_heads * hd,), dtype=dtype,
                                device=device),
              "bk": torch.zeros(lead + (n_kv * hd,), dtype=dtype,
                                device=device),
              "bv": torch.zeros(lead + (n_kv * hd,), dtype=dtype,
                                device=device)}
    return p


def norm_init(lead: tuple, d: int, kind: str, dtype, device) -> dict:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r} is not ported yet "
                                  "(ROADMAP A15)")
    return {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
