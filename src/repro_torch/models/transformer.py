"""The dense decoder path of the model zoo: init / train forward / loss.

Port of ``repro/models/transformer.py:70-108``, ``:115-153`` and ``:186-289``
for ``arch_type == "dense"``.  Parameters are a flat ``dict[str, Tensor]``
keyed by the reference's leaf paths (``"blocks/attn/wq"``, in the order of
``jax.tree_util.tree_leaves``), see :mod:`repro_torch.weights`.  The layer
stack keeps the reference's STACKED leaves: ``blocks/*`` tensors carry a
leading ``(n_layers, ...)`` axis and the forward indexes layer ``l`` out of
them, so a per-leaf histogram or k budget covers the whole stacked leaf as
in the reference.  Weights are used as ``x @ W``, W stored (in, out).

The other architecture families (moe, ssm, hybrid, vlm, audio) and the
serving path (prefill / decode) wait for ROADMAP A14-A15.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from .layers import (_expand_kv, apply_norm, apply_rope, attention_train,
                     attn_init, mlp_forward, mlp_init, norm_init, normal,
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

def init_params(cfg: ArchConfig, generator: torch.Generator | None = None,
                *, seed: int = 0, device: str | torch.device | None = None
                ) -> Params:
    """Random N(0, std) weights with the reference's shapes, names and init
    scales (the values are torch's, not jax.random's).

    ``device=None`` means the card; ``device="meta"`` builds the shapes
    without allocating.  ``generator`` defaults to one on ``device`` seeded
    with ``seed``.
    """
    _check_arch(cfg)
    dev = resolve_device(device)
    gen = generator
    if gen is None and dev.type != "meta":
        gen = torch.Generator(device=dev).manual_seed(seed)
    d, vp, dt, nl = cfg.d_model, cfg.vocab_padded, cfg.dtype, cfg.n_layers
    lead = (nl,)
    tree: dict = {
        "embed": normal(gen, (vp, d), 0.02, dt, dev),
        "final_norm": norm_init((), d, cfg.norm, dt, dev),
        "blocks": {
            "norm1": norm_init(lead, d, cfg.norm, dt, dev),
            "attn": attn_init(gen, lead, d, cfg.n_heads, cfg.n_kv_heads,
                              cfg.hd, cfg.qkv_bias, dt, dev),
            "norm2": norm_init(lead, d, cfg.norm, dt, dev),
            "mlp": mlp_init(gen, lead, d, cfg.d_ff, cfg.mlp, dt, dev),
        },
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal(gen, (d, vp), d ** -0.5, dt, dev)
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
