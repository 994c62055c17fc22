"""The dense decoder path of the model zoo: init / train forward / loss, and
serving: the decode cache, prefill and one-token decode.

Port of ``repro/models/transformer.py:70-108``, ``:115-153``, ``:186-289``,
``:296-319``, ``:335-427`` and ``:472-559`` for ``arch_type == "dense"``.
Parameters are a flat ``dict[str, Tensor]`` keyed by the reference's leaf
paths (``"blocks/attn/wq"``, in the order of
``jax.tree_util.tree_leaves``), see :mod:`repro_torch.weights`.  The layer
stack keeps the reference's STACKED leaves: ``blocks/*`` tensors carry a
leading ``(n_layers, ...)`` axis and the forward indexes layer ``l`` out of
them, so a per-leaf histogram or k budget covers the whole stacked leaf as
in the reference.  Weights are used as ``x @ W``, W stored (in, out).

The decode cache is ``{"pos": int, "kv": {"k", "v"}}`` with ``k`` and ``v``
of shape ``(L, B, Kv, S, hd)`` in ``cfg.dtype``, as in the reference; ``pos``
is a host int, so a decode loop never waits for the card.  A decode step
writes the new token's K/V into the cache IN PLACE (the reference returns
new arrays) and attends through the ``swa_decode`` kernel.

The other architecture families (moe, ssm, hybrid, vlm, audio) wait for
ROADMAP A15.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.device import resolve_device
from .layers import (KVCache, _expand_kv, apply_norm, apply_rope,
                     attention_decode, attention_train, attn_init,
                     cache_update, mlp_forward, mlp_init, norm_init, normal,
                     qkv_project)

Params = dict[str, torch.Tensor]


def _flatten(tree: dict, prefix: str = "") -> Params:
    """Nested dict -> flat dict in sorted-key (jax tree_leaves) order."""
    out: Params = {}
    for k in sorted(tree):
        v = tree[k]
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "/"))
        else:
            out[name] = v
    return out


def _check_arch(cfg: ArchConfig) -> None:
    if cfg.arch_type != "dense":
        raise NotImplementedError(
            f"arch_type {cfg.arch_type!r} is not ported yet (ROADMAP A15)")


# ===========================================================================
# init
# ===========================================================================

def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: str | torch.device | None = None) -> Params:
    """The reference's weights for ``PRNGKey(seed)``
    (``repro/models/transformer.py:70-100``): ``split(key, 8)``, embed from
    key 0 and lm_head from key 1, the stacked blocks from key 2 split once
    per layer, each layer's key split six ways (attention 0, MLP 1); every
    matrix ``normal * scale`` in f32, cast to ``cfg.dtype``, drawn on
    ``device`` with the ported threefry (:mod:`repro_torch.core.prng`).

    ``device=None`` means the card; ``device="meta"`` builds the shapes
    without allocating or drawing."""
    _check_arch(cfg)
    dev = resolve_device(device)
    d, vp, dt, nl = cfg.d_model, cfg.vocab_padded, cfg.dtype, cfg.n_layers
    lead = (nl,)
    if dev.type == "meta":
        ks, attn_keys, mlp_keys = [None] * 8, None, None
    else:
        ks = list(prng.split(prng.PRNGKey(seed), 8))
        blocks = [prng.split(k, 6) for k in prng.split(ks[2], nl)]
        attn_keys = [b[0] for b in blocks]
        mlp_keys = [b[1] for b in blocks]

    def one(k):
        return None if k is None else [k]
    tree: dict = {
        "embed": normal(one(ks[0]), (), (vp, d), 0.02, dt, dev),
        "final_norm": norm_init((), d, cfg.norm, dt, dev),
        "blocks": {
            "norm1": norm_init(lead, d, cfg.norm, dt, dev),
            "attn": attn_init(attn_keys, lead, d, cfg.n_heads,
                              cfg.n_kv_heads, cfg.hd, cfg.qkv_bias, dt, dev),
            "norm2": norm_init(lead, d, cfg.norm, dt, dev),
            "mlp": mlp_init(mlp_keys, lead, d, cfg.d_ff, cfg.mlp, dt, dev),
        },
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal(one(ks[1]), (), (d, vp), d ** -0.5, dt, dev)
    return _flatten(tree)


def param_count(cfg: ArchConfig) -> int:
    """Number of trained parameters, from shapes on the meta device."""
    return sum(p.numel() for p in init_params(cfg, device="meta").values())


def layer_params(params: Params) -> list[dict]:
    """Nested per-layer views ``[{"attn": {"wq": ...}, ...}, ...]`` of the
    stacked ``blocks/*`` leaves.  One ``unbind`` per leaf: its backward
    stacks the per-layer gradients in one write, where indexing each layer
    out separately would accumulate a full-size zero-padded gradient per
    layer."""
    layers: list[dict] = []
    for name, t in params.items():
        parts = name.split("/")
        if parts[0] != "blocks":
            continue
        for i, t_l in enumerate(t.unbind(0)):
            if i == len(layers):
                layers.append({})
            node = layers[i]
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t_l
    return layers


# ===========================================================================
# train forward
# ===========================================================================

def _attn_block_train(x: torch.Tensor, bp: dict, cfg: ArchConfig,
                      positions: torch.Tensor, *, causal: bool = True,
                      window: int = 0) -> torch.Tensor:
    """One attention + FFN block over the full sequence."""
    h = apply_norm(x, bp["norm1"], cfg.norm)
    q, k, v = qkv_project(h, bp["attn"], cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.qkv_bias)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k = _expand_kv(k, cfg.n_heads)
    v = _expand_kv(v, cfg.n_heads)
    att = attention_train(q, k, v, causal=causal, window=window,
                          q_chunk=cfg.attn_q_chunk)
    x = x + att.reshape(*x.shape[:2], -1) @ bp["attn"]["wo"]
    h = apply_norm(x, bp["norm2"], cfg.norm)
    return x + mlp_forward(h, bp["mlp"], cfg.mlp)


def forward_hidden(params: Params, cfg: ArchConfig, tokens: torch.Tensor, *,
                   window: int = 0
                   ) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Full-sequence forward up to the final norm.

    Returns (hidden (B, S, D), aux_loss, n_prefix) as the reference does;
    the dense path has no aux loss and no modality prefix.
    """
    _check_arch(cfg)
    x = params["embed"][tokens]                             # (B,S,D)
    positions = torch.arange(x.shape[1], device=x.device)
    for bp in layer_params(params):
        x = _attn_block_train(x, bp, cfg, positions, window=window)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return apply_norm(x, {"scale": params["final_norm/scale"]}, cfg.norm), \
        aux, 0


def logits_fn(params: Params, cfg: ArchConfig, hidden: torch.Tensor
              ) -> torch.Tensor:
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return (hidden @ head).to(torch.float32)


def lm_loss(params: Params, cfg: ArchConfig, batch: dict) -> torch.Tensor:
    """batch: tokens (B,S), labels (B,S) -> mean next-token cross-entropy.

    The cross-entropy is summed in sequence chunks of ``cfg.loss_chunk`` as
    in the reference, so the (B, S, V) logits never exist at once.
    """
    hidden, aux, n_prefix = forward_hidden(params, cfg, batch["tokens"])
    hidden = hidden[:, n_prefix:]
    labels = batch["labels"]
    b, s, _ = hidden.shape
    chunk = min(cfg.loss_chunk, s)

    def chunk_nll(h_c, y_c):
        logits = logits_fn(params, cfg, h_c)                # (B,c,V) f32
        logz = torch.logsumexp(logits, -1)
        gold = torch.gather(logits, -1, y_c[..., None].long())[..., 0]
        return torch.sum(logz - gold)

    if s % chunk != 0 or s == chunk:
        total = chunk_nll(hidden, labels)
    else:
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for c0 in range(0, s, chunk):
            total = total + chunk_nll(hidden[:, c0:c0 + chunk],
                                      labels[:, c0:c0 + chunk])
    loss = total / (b * s)
    return loss + cfg.router_aux_weight * aux / max(cfg.n_layers, 1)


# ===========================================================================
# caches
# ===========================================================================

def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               device: str | torch.device | None = None) -> dict:
    """Zeroed decode cache sized for ``cache_len`` positions; ``device=None``
    means the card."""
    _check_arch(cfg)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, cache_len, cfg.hd)
    return {"pos": 0,
            "kv": {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
                   "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}}


# ===========================================================================
# decode
# ===========================================================================

def _attn_block_decode(x: torch.Tensor, bp: dict, cfg: ArchConfig,
                       cache: KVCache, pos: int, positions: torch.Tensor,
                       window: int) -> torch.Tensor:
    """x: (B,1,D) -> (B,1,D); writes the token's K/V into ``cache``."""
    b = x.shape[0]
    h = apply_norm(x, bp["norm1"], cfg.norm)
    q, k, v = qkv_project(h, bp["attn"], cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                          cfg.qkv_bias)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    cache = cache_update(cache, k, v, pos, window)
    att = attention_decode(q, cache, cfg.n_heads)
    x = x + att.reshape(b, 1, -1) @ bp["attn"]["wo"]
    h = apply_norm(x, bp["norm2"], cfg.norm)
    return x + mlp_forward(h, bp["mlp"], cfg.mlp)


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                cache: dict, *, window: int = 0
                ) -> tuple[torch.Tensor, dict]:
    """One serving step: token (B,1) int -> (logits (B,Vp) f32, cache).

    The cache's K/V tensors are updated in place; the returned dict holds
    them with ``pos`` advanced by one.
    """
    _check_arch(cfg)
    x = params["embed"][token]                              # (B,1,D)
    pos = int(cache["pos"])
    b = token.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    k_all, v_all = cache["kv"]["k"], cache["kv"]["v"]
    for i, bp in enumerate(layer_params(params)):
        x = _attn_block_decode(x, bp, cfg, KVCache(k_all[i], v_all[i], None),
                               pos, positions, window)
    x = apply_norm(x, {"scale": params["final_norm/scale"]}, cfg.norm)
    logits = logits_fn(params, cfg, x)[:, 0]
    return logits, dict(cache, pos=pos + 1)


# ===========================================================================
# prefill
# ===========================================================================

def prefill(params: Params, cfg: ArchConfig, batch: dict,
            cache_len: int | None = None) -> tuple[torch.Tensor, dict]:
    """Process a full prompt; return (last-position logits (B,Vp) f32,
    decode cache).

    The cache holds the prompt's RoPE'd, un-expanded K/V, padded with zeros
    to ``cache_len`` slots when ``cache_len`` exceeds the prompt and of the
    prompt's length otherwise, as the reference's.  Attention is the plain
    causal ``attention_train``, without a window, as in the reference.
    """
    _check_arch(cfg)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = params["embed"][tokens]                             # (B,S,D)
    positions = torch.arange(s, device=x.device)
    s_cache = cache_len if cache_len is not None and cache_len > s else s
    shape = (cfg.n_layers, b, cfg.n_kv_heads, s_cache, cfg.hd)
    k_c = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
    v_c = torch.zeros(shape, dtype=cfg.dtype, device=x.device)
    for i, bp in enumerate(layer_params(params)):
        h = apply_norm(x, bp["norm1"], cfg.norm)
        q, k, v = qkv_project(h, bp["attn"], cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, cfg.qkv_bias)
        if cfg.use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        k_c[i, :, :, :s] = k.transpose(1, 2)
        v_c[i, :, :, :s] = v.transpose(1, 2)
        att = attention_train(q, _expand_kv(k, cfg.n_heads),
                              _expand_kv(v, cfg.n_heads), causal=True,
                              q_chunk=cfg.attn_q_chunk)
        x = x + att.reshape(b, s, -1) @ bp["attn"]["wo"]
        h = apply_norm(x, bp["norm2"], cfg.norm)
        x = x + mlp_forward(h, bp["mlp"], cfg.mlp)
    x = apply_norm(x[:, -1:], {"scale": params["final_norm/scale"]}, cfg.norm)
    logits = logits_fn(params, cfg, x)[:, 0]
    return logits, {"pos": s, "kv": {"k": k_c, "v": v_c}}
