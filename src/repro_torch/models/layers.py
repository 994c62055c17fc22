"""Transformer primitives: RMSNorm and LayerNorm, RoPE, GQA attention
(train and decode), the decode KV cache, the SwiGLU, GeGLU and GELU MLPs
and the initialisers.  Port of ``repro/models/layers.py:18-291``.

Conventions are the reference's:
  * activations (B, S, D); attention heads (B, S, H, hd)
  * weights are used as ``x @ W`` with W stored (in, out)
  * math in the config dtype (bf16), softmax and norm statistics in f32

``attention_train`` is plain jnp in the reference (no Pallas kernel), so it is
plain torch here.  ``attention_decode`` goes through the ``swa_decode`` CUDA
kernel (:mod:`repro_torch.kernels.swa_attention`), and under a model axis,
over a rank's shard of the cache's slots, through its partial form;
``attention_decode_heads`` through the plain form over a rank's heads of a
cache every rank holds whole (the audio family's cross cache).  The
reference's remat and sequence-sharding knobs change memory and layout, not
values, and have no counterpart on one card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch import parallel
from repro_torch.core import prng
from repro_torch.kernels import (ref, swa_decode, swa_decode_partial,
                                 threefry_normal)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6, *,
            mesh=None) -> torch.Tensor:
    """RMSNorm over the last dim.  ``mesh`` with a model axis of P ranks:
    ``x`` and ``scale`` are this rank's block of that dim (the SSD gated
    norm's d_inner, split by heads), whose squares are summed over the
    ranks (:func:`repro_torch.parallel.sum_over_model`) and divided by the
    whole dim."""
    xf = x.to(torch.float32)
    n = parallel.model_size(mesh)
    if n == 1:
        var = (xf * xf).mean(-1, keepdim=True)
    else:
        var = parallel.sum_over_model(
            mesh, (xf * xf).sum(-1, keepdim=True)) / (xf.shape[-1] * n)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """Mean and variance in f32, cast to x's dtype before the affine, as
    the reference."""
    xf = x.to(torch.float32)
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def apply_norm(x: torch.Tensor, p: dict, kind: str) -> torch.Tensor:
    """``p`` is the norm's subtree: ``scale``, and ``bias`` for layernorm."""
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"])
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


def local_heads(n_heads: int, n_kv: int, model: int) -> tuple[int, int]:
    """(H / P, Kv / P): the query and kv heads each of ``model`` = P ranks
    holds under the model axis.  Heads are contiguous in the ``HK``
    columns of ``wq`` / ``wk`` / ``wv``, so a rank's block of columns is
    whole heads, and :func:`_expand_kv` pairs its q heads with its kv
    heads only when P divides the kv heads.  (The reference's GSPMD also
    splits inside a head; that layout is not ported.)"""
    if model < 1 or n_kv % model or n_heads % model:
        raise ValueError(f"a model axis of {model} must divide n_kv_heads="
                         f"{n_kv} (and n_heads={n_heads}): each rank holds "
                         f"whole kv heads")
    return n_heads // model, n_kv // model


def qkv_project(x: torch.Tensor, p: dict, n_heads: int, n_kv: int, hd: int,
                bias: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, heads, hd).  Under a model axis ``p`` holds the
    rank's column blocks and ``n_heads`` / ``n_kv`` its local counts
    (:func:`local_heads`)."""
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


class KVCache(NamedTuple):
    k: torch.Tensor         # (B, n_kv, S_cache, hd)
    v: torch.Tensor         # (B, n_kv, S_cache, hd)
    length: torch.Tensor    # (B,) int32 valid slots (ring buffer aware)


def attention_decode(q: torch.Tensor, cache: KVCache, n_heads: int, *,
                     mesh=None) -> torch.Tensor:
    """One-token attention over a (possibly ring-buffer) cache through the
    ``swa_decode`` kernel.

    q: (B, 1, H, hd); cache.k/v: (B, Kv, S, hd).  Returns (B, 1, H, hd).
    ``cache.length`` stays a device tensor: nothing here syncs with the
    host.  The reference's jnp version rounds the softmax weights to the
    cache dtype before the value product; the kernel keeps them in f32, as
    the Pallas kernel does, so the two differ in bf16 by that rounding.

    ``mesh`` with a model axis of P ranks: ``cache`` is this rank's block
    of S / P slots of a cache split on its slots (``cache.length`` counts
    the whole cache's valid slots), q is every head's.  The rank attends
    over its valid slots, ``clamp(length - r S / P, 0, S / P)``, through
    the kernel's partial form, and the ranks' softmax states merge
    (:func:`merge_rank_partials`): every rank gets the whole attention.
    """
    b, _, h, hd = q.shape
    if h != n_heads:
        raise ValueError(f"q has {h} heads, expected {n_heads}")
    if parallel.model_size(mesh) == 1:
        out = swa_decode(q[:, 0].contiguous(), cache.k, cache.v,
                         cache.length)
        return out.reshape(b, 1, h, hd)
    s_loc = cache.k.shape[2]
    length = torch.clamp(cache.length - mesh.model_rank * s_loc, 0, s_loc)
    out, m, l_sum = swa_decode_partial(q[:, 0].contiguous(), cache.k,
                                       cache.v, length)
    out = merge_rank_partials(mesh, out, m, l_sum, q.dtype)
    return out.reshape(b, 1, h, hd)


def attention_decode_heads(q: torch.Tensor, cache: KVCache, mesh
                           ) -> torch.Tensor:
    """One-token attention of this rank's query heads over their heads of
    a cache that every rank of a model axis holds whole (the audio
    family's cross cache, ``launch.sharding_rules.cache_specs``), through
    ``swa_decode``'s plain form: no collective, no merge.

    q: (B, 1, H / P, hd), the rank's block of heads r H / P .. (r + 1) H
    / P; cache.k/v: (B, H, S, hd), every query head with its own K/V
    (REP 1).  The rank's heads of batch row b are not contiguous in the
    cache, so the kernel takes the cache as (B P, H / P, S, hd), whose row
    b P + r holds them: the rank's queries sit in its rows, the other
    ranks' rows get length 0, whose slots the kernel never reads.
    Returns (B, 1, H / P, hd)."""
    b, _, h_loc, hd = q.shape
    p, r = mesh.model_size, mesh.model_rank
    _, h, s, _ = cache.k.shape
    if h != h_loc * p:
        raise ValueError(f"q has {h_loc} heads a rank, the cache {h} over "
                         f"{p} ranks")
    rows = torch.zeros((b, p, h_loc, hd), dtype=q.dtype, device=q.device)
    rows[:, r] = q[:, 0]
    length = torch.zeros((b, p), dtype=torch.int32, device=q.device)
    length[:, r] = cache.length
    out = swa_decode(rows.view(b * p, h_loc, hd),
                     cache.k.view(b * p, h_loc, s, hd),
                     cache.v.view(b * p, h_loc, s, hd), length.view(-1))
    return out.view(b, p, h_loc, hd)[:, r, None]


def merge_rank_partials(mesh, out: torch.Tensor, m: torch.Tensor,
                        l_sum: torch.Tensor, dtype: torch.dtype
                        ) -> torch.Tensor:
    """The decode attention over the whole cache from this rank's partial
    state over its slots (``swa_decode_partial``: out (B, H, Dh) f32, m
    and l (B, H)): the states, packed as (B, H, Dh + 2), gathered in rank
    order in one collective and merged as the kernel merges its splits
    (:func:`repro_torch.kernels.ref.merge_decode_partials`), cast to
    ``dtype``; every rank holds the same bits."""
    packed = torch.cat([out, m[..., None], l_sum[..., None]], -1)
    states = parallel.gather_ranks(mesh, packed)
    dh = out.shape[-1]
    return ref.merge_decode_partials(states[..., :dh], states[..., dh],
                                     states[..., dh + 1], dtype)


def cache_update(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: int, window: int = 0, *, mesh=None) -> KVCache:
    """Insert one token's K/V at absolute position ``pos`` (a host int, the
    same for every row), IN PLACE in ``cache.k`` / ``cache.v``.

    With ``window`` the cache is a ring buffer and the token goes to slot
    ``pos % S`` (RoPE is applied before insertion, so slot order does not
    matter to attention); without one it goes to slot ``pos``, and a
    position past the cache's end is dropped, as the reference's
    out-of-bounds ``.at[].set`` drops it.  The returned length is
    ``min(pos + 1, S)`` for every row.  The reference returns new arrays;
    the port writes in place, so a decode step never copies the cache.

    ``mesh`` with a model axis of P ranks: ``cache`` is this rank's block
    of a cache of S = P x its slots, split on its slots in rank order
    (``launch.sharding_rules.cache_specs``); only the slot's owner, rank
    ``slot // (S / P)``, writes it, at ``slot % (S / P)``.  The length is
    the whole cache's.
    """
    b, _, s_loc, _ = cache.k.shape
    p = parallel.model_size(mesh)
    s_cache = s_loc * p
    slot = pos % s_cache if window else pos
    if 0 <= slot < s_cache:
        owner, slot = divmod(slot, s_loc)
        if p == 1 or owner == mesh.model_rank:
            # k_new: (B,1,Kv,hd) -> (B,Kv,hd)
            cache.k[:, :, slot] = k_new[:, 0].to(cache.k.dtype)
            cache.v[:, :, slot] = v_new[:, 0].to(cache.v.dtype)
    length = torch.full((b,), min(pos + 1, s_cache), dtype=torch.int32,
                        device=cache.k.device)
    return KVCache(cache.k, cache.v, length)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation (torch's default
    is the erf form, another function)."""
    return F.gelu(x, approximate="tanh")


def mlp_forward(x: torch.Tensor, p: dict, kind: str, *,
                down_bias: bool = True) -> torch.Tensor:
    """The MLP of ``kind``; ``down_bias=False`` leaves the plain GELU
    MLP's ``b_down`` out, for a caller that adds it after summing the
    model axis's partial outputs."""
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    if kind == "geglu":
        return (gelu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # the plain GELU MLP with biases (whisper)
    y = gelu(x @ p["w_up"] + p["b_up"]) @ p["w_down"]
    return y + p["b_down"] if down_bias else y


# ---------------------------------------------------------------------------
# initialisers: the reference's N(0, 1) * std draws from the ported threefry
# (``jax.random.normal(key, shape) * std``, then the cast to the dtype).
# ``keys`` holds one key per layer of the stacked prefix ``lead`` (one key
# when ``lead`` is empty); ``None`` on the meta device, which draws nothing.
# ---------------------------------------------------------------------------

def normal(keys: list | None, lead: tuple, shape: tuple, std: float,
           dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One stacked leaf: layer i is ``normal(keys[i], shape) * std`` in f32,
    cast to ``dtype``, drawn in place by the threefry_normal kernel on the
    card (one launch a layer) and by its plain version on the CPU, which
    holds one layer's f32 draw at a time."""
    out = torch.empty(lead + shape, dtype=dtype, device=device)
    if device.type == "meta":
        return out
    rows = out.view((-1,) + shape)
    for i, k in enumerate(keys):
        threefry_normal(rows[i], k, std)
    return out


def _split_each(keys: list | None, n: int) -> list:
    """The n keys of ``split(k, n)`` for every k of ``keys``, transposed:
    entry j lists key j of every layer."""
    if keys is None:
        return [None] * n
    per = [prng.split(k, n) for k in keys]
    return [[p[j] for p in per] for j in range(n)]


def mlp_init(keys: list | None, lead: tuple, d: int, dff: int, kind: str,
             dtype, device) -> dict:
    """``layers.mlp_init``: keys split three ways (gate, up, down); the
    plain GELU MLP draws up from the first and down from the third, and
    its biases are zeros."""
    s_in, s_ff = d ** -0.5, dff ** -0.5
    k1, k2, k3 = _split_each(keys, 3)
    if kind in ("swiglu", "geglu"):
        return {
            "w_gate": normal(k1, lead, (d, dff), s_in, dtype, device),
            "w_up": normal(k2, lead, (d, dff), s_in, dtype, device),
            "w_down": normal(k3, lead, (dff, d), s_ff, dtype, device),
        }
    return {
        "w_up": normal(k1, lead, (d, dff), s_in, dtype, device),
        "b_up": torch.zeros(lead + (dff,), dtype=dtype, device=device),
        "w_down": normal(k3, lead, (dff, d), s_ff, dtype, device),
        "b_down": torch.zeros(lead + (d,), dtype=dtype, device=device),
    }


def attn_init(keys: list | None, lead: tuple, d: int, n_heads: int,
              n_kv: int, hd: int, bias: bool, dtype, device) -> dict:
    """``layers.attn_init``: keys split four ways (q, k, v, o)."""
    s = d ** -0.5
    kq, kk, kv, ko = _split_each(keys, 4)
    p = {
        "wq": normal(kq, lead, (d, n_heads * hd), s, dtype, device),
        "wk": normal(kk, lead, (d, n_kv * hd), s, dtype, device),
        "wv": normal(kv, lead, (d, n_kv * hd), s, dtype, device),
        "wo": normal(ko, lead, (n_heads * hd, d), (n_heads * hd) ** -0.5,
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
    p = {"scale": torch.ones(lead + (d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=dtype, device=device)
    return p
