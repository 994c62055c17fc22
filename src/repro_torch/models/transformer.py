"""The model zoo: init, the dense train forward / loss, and serving (the
decode cache, prefill and one-token decode) for the dense, moe, ssm,
hybrid, vlm and audio families.

Port of ``repro/models/transformer.py:63-108``, ``:115-153``, ``:186-289``,
``:296-333``, ``:335-469`` and ``:472-627``.  Parameters are a flat
``dict[str, Tensor]`` keyed by the reference's leaf paths
(``"blocks/attn/wq"``, in the order of ``jax.tree_util.tree_leaves``), see
:mod:`repro_torch.weights`.  The layer stack keeps the reference's STACKED
leaves: ``blocks/*`` tensors carry a leading ``(n_layers, ...)`` axis (the
moe experts ``(n_layers, E, ...)``) and the forward indexes layer ``l`` out
of them, so a per-leaf histogram or k budget covers the whole stacked leaf
as in the reference.  The hybrid's one shared attention + MLP block is the
unstacked ``shared/*``; the audio family's encoder is ``enc_blocks/*``,
its decoder blocks carry ``norm_x`` and ``cross`` (cross-attention), and
``enc_pos`` / ``dec_pos`` are its learned positions; the vlm family's
``vis_proj`` projects the (B, P, 1024) patch-embedding prefix.  Weights
are used as ``x @ W``, W stored (in, out).

The decode cache is the reference's: ``{"pos": int}`` with ``"kv":
{"k", "v"}`` of shape ``(L, B, Kv, S, hd)`` in ``cfg.dtype`` (dense, moe;
the hybrid keeps one K/V site per shared-block application,
``ceil(L / attn_every)``), ``"ssm": {"conv" (L, B, K-1, C) in
``cfg.dtype``, "state" (L, B, H, P, N) f32}`` (ssm, hybrid) and the audio
family's ``"cross_k"`` / ``"cross_v"`` (L, B, H, encoder_seq, hd), the
encoder output's cross-attention K/V, written once by prefill.  ``pos`` is
a host int, so a decode loop never waits for the card.  A decode step
writes the new token's K/V and the SSM conv tails and states IN PLACE (the
reference returns new arrays) and attends through the ``swa_decode``
kernel, over the cross cache too.

The train forward and loss (``forward_hidden``, ``lm_loss``) run all six
families: the MoE's load-balance loss summed over the blocks, the SSD
blocks' chunked scan under autograd, the hybrid's shared block before each
run of ``attn_every`` SSD blocks, the vlm's patch prefix (no loss on its
positions) and the audio encoder with the decoder's cross-attention.

Under a model axis P > 1 (``mesh=``, ROADMAP A12) the dense family trains
tensor-parallel on each rank's shards (``launch.sharding_rules``): the
vocab-parallel embedding lookup, :func:`repro_torch.parallel.
copy_to_model` before the column-parallel ``wq`` / ``wk`` / ``wv`` and
``w_gate`` / ``w_up``, ``reduce_from_model`` after the row-parallel
``wo`` and ``w_down``, and a vocab-parallel cross-entropy.  The blocks are
the same functions at P = 1, where those collectives return their input.
The ssm and hybrid families train so too (A12c): each SSD block runs
H / P heads (:mod:`repro_torch.models.ssd`: ``in_proj``'s output gathered,
the gated norm's squares summed over the ranks), the hybrid's shared block
as a dense block at each of its sites, and the SSD leaves held whole but
used a head block at a time get their gradients summed over the ranks
(:func:`sum_split_use_grads`, called by the train steps).  The moe
family's blocks are the dense family's with the expert layer on the
rank's experts, or on each expert's block of F (:mod:`repro_torch.models.
moe`: the dispatch global on every rank, the partial outputs summed, the
router's gradient summed with the SSD leaves', the load-balance loss
counted once); the vlm family's ``vis_proj`` projects the patches on the
rank's columns, gathered whole (``parallel.gather_to_model``).  The audio
family's encoder blocks are dense blocks on the rank's heads and MLP
columns; its output, the same bits on every rank, passes once through
``copy_to_model`` before the decoder, whose blocks each project the
rank's heads' cross K/V from it (so its gradient there is partial); the
cross-attention runs on the rank's heads, its ``wo`` rows summed.

It also serves there (A12b): the decode cache is split on its slots as
``sharding_rules.cache_specs`` splits it (S / P slots a rank, every KV
head, when P divides S; whole on every rank otherwise), and the cache
carries ``"slots"``, the whole cache's S.  Prefill runs the head-parallel
blocks of training and gathers the prompt's K/V over the heads, each rank
keeping its slots.  A decode step gathers the token's q / k / v over the
ranks (:func:`repro_torch.parallel.gather_columns`), the slot's owner
writes the K/V, each rank attends over its slots through ``swa_decode``'s
partial form and the ranks' softmax states merge; the rank's heads of the
merged attention go through its rows of ``wo``.  The vocab-parallel
logits are gathered whole, so every rank takes the same greedy token.
The ssm and hybrid families serve there too: the SSD state is split on
its heads and the conv tail on its channels (``cache_specs``), the
hybrid's K/V sites on their slots as the dense family's cache; so do the
moe and vlm families, whose caches are the dense family's, and the audio
family, whose cross cache is whole on every rank: prefill gathers every
head's cross K/V into it, and a decode step attends with the rank's query
heads over their heads of it (:func:`repro_torch.models.layers.
attention_decode_heads`), with no merge.
"""
from __future__ import annotations

import torch

from repro_torch import parallel
from repro_torch.configs.base import ArchConfig
from repro_torch.core import prng
from repro_torch.device import resolve_device
from . import moe as moe_lib
from . import ssd as ssd_lib
from .layers import (KVCache, _expand_kv, _split_each, apply_norm,
                     apply_rope, attention_decode, attention_decode_heads,
                     attention_train, attn_init, cache_update, local_heads,
                     mlp_forward, mlp_init, norm_init, normal, qkv_project)

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


#: the ported families (init, train forward and loss, cache, prefill, decode)
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")
#: the families whose blocks are all attention + FFN blocks
_ATTN = ("dense", "moe", "vlm", "audio")
#: the width of the vlm family's patch embeddings (the stub CLIP encoder)
VIS_STUB_DIM = 1024


def _check_arch(cfg: ArchConfig) -> None:
    if cfg.arch_type not in FAMILIES:
        raise ValueError(f"unknown arch_type {cfg.arch_type!r}; the families "
                         f"are {FAMILIES}")


# ===========================================================================
# init
# ===========================================================================

def _block_init(cfg: ArchConfig, keys: list | None, lead: tuple,
                dev: torch.device, *, cross: bool = False) -> dict:
    """``_block_init`` for each key of the stacked prefix ``lead``: each key
    split six ways (attention 0, MLP or MoE 1, cross-attention 2, which has
    no bias whatever ``cfg.qkv_bias`` says)."""
    ks = _split_each(keys, 6)
    d, dt = cfg.d_model, cfg.dtype
    p = {
        "norm1": norm_init(lead, d, cfg.norm, dt, dev),
        "attn": attn_init(ks[0], lead, d, cfg.n_heads, cfg.n_kv_heads,
                          cfg.hd, cfg.qkv_bias, dt, dev),
        "norm2": norm_init(lead, d, cfg.norm, dt, dev),
    }
    if cfg.arch_type == "moe":
        p["moe"] = moe_lib.moe_init(ks[1], lead, d, cfg.n_experts,
                                    cfg.d_exp, cfg.mlp, dt, dev)
    else:
        p["mlp"] = mlp_init(ks[1], lead, d, cfg.d_ff, cfg.mlp, dt, dev)
    if cross:
        p["norm_x"] = norm_init(lead, d, cfg.norm, dt, dev)
        p["cross"] = attn_init(ks[2], lead, d, cfg.n_heads, cfg.n_kv_heads,
                               cfg.hd, False, dt, dev)
    return p


def _ssm_block_init(cfg: ArchConfig, keys: list | None, lead: tuple,
                    dev: torch.device) -> dict:
    return {"norm1": norm_init(lead, cfg.d_model, cfg.norm, cfg.dtype, dev),
            "ssm": ssd_lib.ssm_init(keys, lead, cfg, cfg.dtype, dev)}


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device: str | torch.device | None = None) -> Params:
    """The reference's weights for ``PRNGKey(seed)``
    (``repro/models/transformer.py:63-108``): ``split(key, 8)``, embed from
    key 0 and lm_head from key 1, the stacked blocks from key 2 split once
    per layer (attention blocks split each layer's key six ways, attention
    0 and MLP / MoE 1; SSD blocks use it whole), the hybrid's shared block
    from key 3; audio: the encoder blocks from key 2, the decoder blocks
    (with cross-attention, from each layer's subkey 2) from key 3,
    ``enc_pos`` from key 4 and ``dec_pos`` from key 5 (both x 0.01); vlm:
    ``vis_proj`` from key 6; every matrix ``normal * scale`` in f32, cast
    to ``cfg.dtype`` (the MoE router stays f32), drawn on ``device`` with
    the ported threefry (:mod:`repro_torch.core.prng`).

    ``device=None`` means the card; ``device="meta"`` builds the shapes
    without allocating or drawing."""
    _check_arch(cfg)
    dev = resolve_device(device)
    d, vp, dt, nl = cfg.d_model, cfg.vocab_padded, cfg.dtype, cfg.n_layers
    ks = [None] * 8 if dev.type == "meta" else \
        list(prng.split(prng.PRNGKey(seed), 8))

    def one(k):
        return None if k is None else [k]

    def stacked(k, n):
        return None if k is None else list(prng.split(k, n))
    tree: dict = {
        "embed": normal(one(ks[0]), (), (vp, d), 0.02, dt, dev),
        "final_norm": norm_init((), d, cfg.norm, dt, dev),
    }
    if cfg.arch_type in ("dense", "moe", "vlm"):
        tree["blocks"] = _block_init(cfg, stacked(ks[2], nl), (nl,), dev)
    elif cfg.arch_type == "audio":
        ne = cfg.encoder_layers
        tree["enc_blocks"] = _block_init(cfg, stacked(ks[2], ne), (ne,), dev)
        tree["blocks"] = _block_init(cfg, stacked(ks[3], nl), (nl,), dev,
                                     cross=True)
        tree["enc_norm"] = norm_init((), d, cfg.norm, dt, dev)
        tree["enc_pos"] = normal(one(ks[4]), (), (cfg.encoder_seq, d), 0.01,
                                 dt, dev)
        tree["dec_pos"] = normal(one(ks[5]), (), (cfg.max_position, d), 0.01,
                                 dt, dev)
    else:
        tree["blocks"] = _ssm_block_init(cfg, stacked(ks[2], nl), (nl,), dev)
    if cfg.arch_type == "hybrid":
        tree["shared"] = _block_init(cfg, one(ks[3]), (), dev)
    if cfg.arch_type == "vlm":
        tree["vis_proj"] = normal(one(ks[6]), (), (VIS_STUB_DIM, d),
                                  VIS_STUB_DIM ** -0.5, dt, dev)
    if not cfg.tie_embeddings:
        tree["lm_head"] = normal(one(ks[1]), (), (d, vp), d ** -0.5, dt, dev)
    return _flatten(tree)


def param_count(cfg: ArchConfig) -> int:
    """Number of trained parameters, from shapes on the meta device."""
    return sum(p.numel() for p in init_params(cfg, device="meta").values())


def subtree(params: Params, prefix: str) -> dict:
    """The nested view of the leaves under ``prefix/`` (the hybrid's
    unstacked ``shared`` block, a norm's ``scale`` and ``bias``)."""
    out: dict = {}
    for name, t in params.items():
        parts = name.split("/")
        if parts[0] != prefix:
            continue
        node = out
        for p in parts[1:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = t
    return out


def layer_params(params: Params, stack: str = "blocks") -> list[dict]:
    """Nested per-layer views ``[{"attn": {"wq": ...}, ...}, ...]`` of the
    stacked ``blocks/*`` leaves (``stack="enc_blocks"``: the audio
    family's encoder).  One ``unbind`` per leaf: its backward
    stacks the per-layer gradients in one write, where indexing each layer
    out separately would accumulate a full-size zero-padded gradient per
    layer."""
    layers: list[dict] = []
    for name, t in params.items():
        parts = name.split("/")
        if parts[0] != stack:
            continue
        for i, t_l in enumerate(t.unbind(0)):
            if i == len(layers):
                layers.append({})
            node = layers[i]
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = t_l
    return layers


def _ffn(x: torch.Tensor, bp: dict, cfg: ArchConfig, mesh=None
         ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The block's second half: norm2, then the MLP or the MoE layer, and
    the residual add.  Returns (x, the MoE's aux loss or None); serving
    drops the aux loss.  Under a model axis (``mesh``) the MLP's columns
    are this rank's: its partial output is summed over the ranks before
    the replicated ``b_down`` joins it once; the MoE layer runs on the
    rank's experts (:func:`repro_torch.models.moe.moe_forward`)."""
    h = apply_norm(x, bp["norm2"], cfg.norm)
    if "moe" in bp:
        y, aux = moe_lib.moe_forward(
            h, bp["moe"], n_experts=cfg.n_experts, top_k=cfg.experts_per_tok,
            capacity_factor=cfg.moe_capacity_factor, mlp_kind=cfg.mlp,
            mesh=mesh)
        return x + y, aux
    p = bp["mlp"]
    y = parallel.reduce_from_model(mesh, mlp_forward(
        parallel.copy_to_model(mesh, h), p, cfg.mlp, down_bias=False))
    if "b_down" in p:
        y = y + p["b_down"]
    return x + y, None


# ===========================================================================
# train forward
# ===========================================================================

def _attn_block_train(x: torch.Tensor, bp: dict, cfg: ArchConfig,
                      positions: torch.Tensor, *, causal: bool = True,
                      window: int = 0, enc_out: torch.Tensor | None = None,
                      mesh=None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """One attention + FFN block over the full sequence; returns (x, the
    MoE's aux loss or None).  With ``enc_out`` (the audio decoder) the
    block cross-attends to the encoder output, non-causally, after its
    self-attention.  Under a model axis (``mesh``) the block runs on this
    rank's heads and MLP columns or experts, its row-parallel outputs
    summed over the ranks."""
    n_h, n_kv = local_heads(cfg.n_heads, cfg.n_kv_heads,
                            parallel.model_size(mesh))
    h = parallel.copy_to_model(mesh, apply_norm(x, bp["norm1"], cfg.norm))
    q, k, v = qkv_project(h, bp["attn"], n_h, n_kv, cfg.hd, cfg.qkv_bias)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    k = _expand_kv(k, n_h)
    v = _expand_kv(v, n_h)
    att = attention_train(q, k, v, causal=causal, window=window,
                          q_chunk=cfg.attn_q_chunk)
    b, s = x.shape[:2]
    x = x + parallel.reduce_from_model(
        mesh, att.reshape(b, s, -1) @ bp["attn"]["wo"])
    if enc_out is not None:
        x, _, _ = _cross_train(x, bp, cfg, enc_out, mesh)
    return _ffn(x, bp, cfg, mesh)


def _cross_train(x: torch.Tensor, bp: dict, cfg: ArchConfig,
                 enc: torch.Tensor, mesh=None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The audio decoder block's cross-attention over the whole sequence
    (the reference's ``transformer.py:133-142``): q from ``norm_x(x)``,
    K/V from the encoder output ``enc``, non-causal, then ``wo``.  Returns
    (x, the cross K, the cross V (B, S_enc, heads, hd)).  Under a model
    axis (``mesh``) on this rank's heads (``wq`` / ``wk`` / ``wv`` column
    blocks), its rows of ``wo`` summed over the ranks; ``enc`` is the
    same on every rank and has passed through ``copy_to_model`` once
    (:func:`_encode`)."""
    b, s, _ = x.shape
    n_h, n_kv = local_heads(cfg.n_heads, cfg.n_kv_heads,
                            parallel.model_size(mesh))
    h = parallel.copy_to_model(mesh, apply_norm(x, bp["norm_x"], cfg.norm))
    q = (h @ bp["cross"]["wq"]).reshape(b, s, n_h, cfg.hd)
    ck, cv = _cross_kv(enc, bp["cross"], cfg, n_h, n_kv)
    att = attention_train(q, ck, cv, causal=False, q_chunk=cfg.attn_q_chunk)
    x = x + parallel.reduce_from_model(
        mesh, att.reshape(b, s, -1) @ bp["cross"]["wo"])
    return x, ck, cv


def _ssm_block_train(x: torch.Tensor, bp: dict, cfg: ArchConfig, mesh=None
                     ) -> torch.Tensor:
    """One SSD block over the full sequence (its final state and conv tail
    are dropped); head-parallel under a model axis (``mesh``)."""
    y, _, _ = ssd_lib.ssm_block(apply_norm(x, bp["norm1"], cfg.norm),
                                bp["ssm"], cfg, mesh)
    return x + y


def _hybrid_train(x: torch.Tensor, params: Params, cfg: ArchConfig,
                  positions: torch.Tensor, window: int, mesh=None
                  ) -> torch.Tensor:
    """zamba2: the shared attention block at the start of each run of
    ``attn_every`` SSD blocks (its aux loss dropped, as the reference's);
    its gradient sums over the sites."""
    period = cfg.attn_every or cfg.n_layers
    shared = subtree(params, "shared")
    for i, bp in enumerate(layer_params(params)):
        if i % period == 0:
            x, _ = _attn_block_train(x, shared, cfg, positions, window=window,
                                     mesh=mesh)
        x = _ssm_block_train(x, bp, cfg, mesh)
    return x


def forward_hidden(params: Params, cfg: ArchConfig, tokens: torch.Tensor,
                   prefix: torch.Tensor | None = None, *, window: int = 0,
                   mesh=None) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Full-sequence forward up to the final norm (reference
    ``transformer.py:186-229``).

    Returns (hidden (B, S_total, D), aux_loss, n_prefix): the aux loss is
    the sum of the MoE blocks' load-balance losses (0 elsewhere), and the
    first n_prefix positions are the vlm's patch positions, which take no
    LM loss.  ``prefix`` is the modality stub: vlm (B, P, 1024) patch
    embeddings, projected by ``vis_proj`` and prepended; audio (B, S_enc,
    D) frame embeddings through the encoder, the decoder tokens taking
    ``dec_pos[min(position, max_position - 1)]`` and cross-attending to
    the encoder output in every block.

    ``mesh`` with a model axis P > 1: ``params`` are this rank's shards
    and every family's blocks run tensor-parallel (module docstring).
    """
    _check_arch(cfg)
    tp = model_axis_mesh(cfg, mesh)
    x = (params["embed"][tokens] if tp is None             # (B,S,D)
         else _embed_tp(params["embed"], tokens, tp))
    n_prefix = 0
    if cfg.arch_type in ("vlm", "audio") and prefix is None:
        raise ValueError(f"the {cfg.arch_type} family needs a modality "
                         f"prefix (batch['prefix'])")
    if cfg.arch_type == "vlm":
        vis = parallel.gather_to_model(
            tp, prefix.to(cfg.dtype) @ params["vis_proj"])
        x = torch.cat([vis, x], 1)
        n_prefix = vis.shape[1]
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.arch_type in ("dense", "moe", "vlm"):
        for bp in layer_params(params):
            x, a = _attn_block_train(x, bp, cfg, positions, window=window,
                                     mesh=tp)
            if a is not None:
                aux = aux + a
    elif cfg.arch_type == "ssm":
        for bp in layer_params(params):
            x = _ssm_block_train(x, bp, cfg, tp)
    elif cfg.arch_type == "hybrid":
        x = _hybrid_train(x, params, cfg, positions, window, tp)
    else:                                                   # audio
        enc = _encode(params, cfg, prefix, tp)
        x = x + params["dec_pos"][
            torch.clamp(positions, max=cfg.max_position - 1)][None]
        for bp in layer_params(params):
            x, _ = _attn_block_train(x, bp, cfg, positions, window=window,
                                     enc_out=enc, mesh=tp)
    return (apply_norm(x, subtree(params, "final_norm"), cfg.norm), aux,
            n_prefix)


def logits_fn(params: Params, cfg: ArchConfig, hidden: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """(..., Vp) f32 logits; under a model axis this rank's (..., Vp / P)
    block of the vocab."""
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    hidden = parallel.copy_to_model(model_axis_mesh(cfg, mesh), hidden)
    return (hidden @ head).to(torch.float32)


def lm_loss(params: Params, cfg: ArchConfig, batch: dict, *,
            mesh=None) -> torch.Tensor:
    """batch: tokens (B,S), labels (B,S), and the vlm / audio families'
    ``prefix`` -> mean next-token cross-entropy over the token positions,
    plus ``router_aux_weight * aux / n_layers`` (reference
    ``transformer.py:255-289``).

    The cross-entropy is summed in sequence chunks of ``cfg.loss_chunk`` as
    in the reference, so the (B, S, V) logits never exist at once.  Under
    a model axis (``mesh``) each chunk's logits are split over the vocab:
    the log-sum-exp takes its shift from a MAX over the ranks and its sum
    of exponentials from a SUM, the gold logit from the one rank that
    holds it; every rank returns the same loss.
    """
    tp = model_axis_mesh(cfg, mesh)
    hidden, aux, n_prefix = forward_hidden(params, cfg, batch["tokens"],
                                           batch.get("prefix"), mesh=mesh)
    hidden = hidden[:, n_prefix:]
    labels = batch["labels"]
    b, s, _ = hidden.shape
    chunk = min(cfg.loss_chunk, s)

    def chunk_nll(h_c, y_c):
        logits = logits_fn(params, cfg, h_c, mesh)          # (B,c,V) f32
        if tp is not None:
            return _vocab_parallel_nll(logits, y_c, tp)
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
# the model axis: every family tensor-parallel
# ===========================================================================

def check_model_axis(cfg: ArchConfig, model: int) -> None:
    """Raise ValueError unless a model axis of ``model`` = P ranks can
    split ``cfg``: P must divide the attention's kv heads, the SSD heads
    and the padded vocab (the vocab-parallel ``embed``); a P that does not
    divide the experts splits each expert's F.  Reads the config only, so
    a caller can check before any weight is drawn."""
    _check_arch(cfg)
    if cfg.arch_type != "ssm":
        local_heads(cfg.n_heads, cfg.n_kv_heads, model)
    if cfg.arch_type in ("ssm", "hybrid"):
        ssd_lib.local_ssm_heads(cfg, model)
    if cfg.vocab_padded % model:
        raise ValueError(f"a model axis of {model} must divide the padded "
                         f"vocab {cfg.vocab_padded} of {cfg.name}: each "
                         f"rank holds a block of the embedding's rows")


def model_axis_mesh(cfg: ArchConfig, mesh):
    """``mesh`` when it has a model axis above 1 that can split ``cfg``
    (:func:`check_model_axis`), else None."""
    if mesh is None or mesh.model_size == 1:
        return None
    check_model_axis(cfg, mesh.model_size)
    return mesh


def split_use_leaves(cfg: ArchConfig, names) -> list[str]:
    """The leaves of ``names`` held whole on every rank whose use the model
    axis splits: the SSD blocks' :data:`ssd.SPLIT_USE` (by heads) and the
    MoE router (by experts or by their F)."""
    if cfg.arch_type == "moe":
        return [k for k in names if k == "blocks/moe/router"]
    if cfg.arch_type not in ("ssm", "hybrid"):
        return []
    return [k for k in names if k.startswith("blocks/ssm/")
            and k.rsplit("/", 1)[-1] in ssd_lib.SPLIT_USE]


def sum_split_use_grads(cfg: ArchConfig, grads: dict, mesh) -> dict:
    """``grads`` (this rank's, by leaf) with the gradients of
    :func:`split_use_leaves` summed over the model group, in one
    collective: each rank's gives only its heads' part, and the step must
    see the whole gradient (the same on every rank) before the optimizer
    or the LGC compression.  ``grads`` itself without a model axis."""
    tp = model_axis_mesh(cfg, mesh)
    keys = split_use_leaves(cfg, grads) if tp is not None else []
    if not keys:
        return grads
    summed = parallel.all_reduce_sum_tensors(tp, [grads[k] for k in keys])
    return grads | dict(zip(keys, summed))


def _embed_tp(embed: torch.Tensor, tokens: torch.Tensor, mesh
              ) -> torch.Tensor:
    """The vocab-parallel lookup: this rank's rows of ``embed`` (Vp / P,
    D) for the ids they hold, zeros for the rest, summed over the ranks
    (exactly one rank adds each id's row)."""
    rows = embed.shape[0]
    local = tokens - mesh.model_rank * rows
    inside = (local >= 0) & (local < rows)
    x = embed[torch.where(inside, local, torch.zeros_like(local))]
    x = torch.where(inside[..., None], x, torch.zeros_like(x))
    return parallel.reduce_from_model(mesh, x)


def _vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor, mesh
                        ) -> torch.Tensor:
    """sum(logsumexp - gold) of one chunk from this rank's (B, c, Vp / P)
    f32 block of its logits: the shift is the MAX over the ranks of the
    blocks' maxima (no gradient, as the log-sum-exp's own shift), the
    exponentials' sums and the gold logit (held by one rank, zero
    elsewhere) are summed over the ranks.  The padded vocab columns are
    in some rank's block, and count as in the unsharded loss."""
    cols = logits.shape[-1]
    shift = parallel.all_reduce_max(mesh, logits.detach().amax(-1))
    sums = parallel.reduce_from_model(
        mesh, torch.exp(logits - shift[..., None]).sum(-1))
    local = labels.long() - mesh.model_rank * cols
    inside = (local >= 0) & (local < cols)
    gold = torch.gather(logits, -1, torch.where(
        inside, local, torch.zeros_like(local))[..., None])[..., 0]
    gold = parallel.reduce_from_model(
        mesh, torch.where(inside, gold, torch.zeros_like(gold)))
    return torch.sum(torch.log(sums) + shift - gold)


# ===========================================================================
# caches
# ===========================================================================

def _n_sites(cfg: ArchConfig) -> int:
    """The hybrid's shared-block applications: one before every
    ``attn_every`` SSD blocks."""
    return -(-cfg.n_layers // (cfg.attn_every or cfg.n_layers))


def _kv_cache(cfg: ArchConfig, n_l: int, batch: int, length: int,
              dev: torch.device) -> dict:
    shape = (n_l, batch, cfg.n_kv_heads, length, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


def _ssm_cache(cfg: ArchConfig, batch: int, dev: torch.device, mesh=None
               ) -> dict:
    """The SSD blocks' conv tails and states; under a model axis this
    rank's block of the channels (``ssd.conv_channels``) and its heads."""
    heads = ssd_lib.local_ssm_heads(cfg, parallel.model_size(mesh))
    return {
        "conv": torch.zeros((cfg.n_layers, batch, cfg.ssm_conv - 1,
                             ssd_lib.conv_channels(cfg, mesh)),
                            dtype=cfg.dtype, device=dev),
        "state": torch.zeros((cfg.n_layers, batch, heads,
                              cfg.ssm_head_dim, cfg.ssm_state),
                             dtype=torch.float32, device=dev)}


def local_slots(slots: int, mesh) -> int:
    """The slots of a ``slots``-slot K/V cache that one rank holds under a
    model axis of P ranks (``launch.sharding_rules.cache_specs``): S / P
    when P divides S, else all of them."""
    p = parallel.model_size(mesh)
    return slots // p if slots % p == 0 else slots


def _split_kv(cache: dict, mesh):
    """``mesh`` when this rank's K/V cache is a block of the cache's slots
    (``"slots"``, the whole cache's S, differs from its own), else None."""
    if mesh is None:
        return None
    own = cache["kv"]["k"].shape[3]
    return mesh if cache.get("slots", own) != own else None


def init_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
               device: str | torch.device | None = None, mesh=None) -> dict:
    """Zeroed decode cache sized for ``cache_len`` positions; ``device=None``
    means the card.  Under a model axis (``mesh``) this rank's block of it
    (``sharding_rules.cache_specs``): the K/V's :func:`local_slots`, with
    ``"slots"`` = ``cache_len`` where there are K/V, the SSD conv tails'
    block of channels and the states' heads; the audio family's cross
    cache whole."""
    _check_arch(cfg)
    dev = resolve_device(device)
    tp = model_axis_mesh(cfg, mesh)
    cache: dict = {"pos": 0}
    if tp is not None and cfg.arch_type != "ssm":
        cache["slots"] = cache_len
    if cfg.arch_type in _ATTN:
        cache["kv"] = _kv_cache(cfg, cfg.n_layers, batch,
                                local_slots(cache_len, tp), dev)
    else:
        cache["ssm"] = _ssm_cache(cfg, batch, dev, tp)
    if cfg.arch_type == "hybrid":
        cache["kv"] = _kv_cache(cfg, _n_sites(cfg), batch,
                                local_slots(cache_len, tp), dev)
    if cfg.arch_type == "audio":
        cache |= _cross_cache(cfg, batch, cfg.encoder_seq, dev)
    return cache


def _cross_cache(cfg: ArchConfig, batch: int, enc_len: int,
                 dev: torch.device) -> dict:
    """The audio family's cross-attention K/V, (L, B, H, enc_len, hd): the
    reference keeps them expanded to the H query heads.  Whole on every
    rank of a model axis (``sharding_rules.cache_specs``)."""
    shape = (cfg.n_layers, batch, cfg.n_heads, enc_len, cfg.hd)
    return {"cross_k": torch.zeros(shape, dtype=cfg.dtype, device=dev),
            "cross_v": torch.zeros(shape, dtype=cfg.dtype, device=dev)}


# ===========================================================================
# decode
# ===========================================================================

def _gather_heads(mesh, *parts: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's heads of each of ``parts`` (B, S, local heads, hd),
    put together in rank order, which is the heads' order: one
    :func:`repro_torch.parallel.gather_columns` of them all."""
    b, s = parts[0].shape[:2]
    widths = [t.shape[2] * t.shape[3] for t in parts]
    whole = parallel.gather_columns(mesh, torch.cat(
        [t.reshape(b, s, -1) for t in parts], -1))
    blocks = whole.reshape(b, s, mesh.model_size, sum(widths)).split(
        widths, -1)
    return [blk.reshape(b, s, -1, t.shape[3]) for blk, t in zip(blocks, parts)]


def _attn_block_decode(x: torch.Tensor, bp: dict, cfg: ArchConfig,
                       cache: KVCache, pos: int, positions: torch.Tensor,
                       window: int, cross: KVCache | None = None, *,
                       mesh=None, kv_mesh=None) -> torch.Tensor:
    """x: (B,1,D) -> (B,1,D); writes the token's K/V into ``cache``.  With
    ``cross`` (the audio decoder) the token then attends to the encoder's
    cached K/V: only its query is projected, since the reference's
    cross-attention discards the token's own K and V.

    Under a model axis (``mesh``) the rank projects its heads' q / k / v,
    gathers every head's, writes the K/V where it owns the slot and
    attends (``kv_mesh``: the cache is split on its slots, see
    :func:`repro_torch.models.layers.attention_decode`; None: whole on
    every rank); its heads of the attention go through its rows of
    ``wo``, summed over the ranks.  Its heads' cross query attends over
    their heads of the whole cross cache
    (:func:`repro_torch.models.layers.attention_decode_heads`), through
    its rows of the cross ``wo``, summed."""
    b = x.shape[0]
    n_h, n_kv = local_heads(cfg.n_heads, cfg.n_kv_heads,
                            parallel.model_size(mesh))
    h = apply_norm(x, bp["norm1"], cfg.norm)
    q, k, v = qkv_project(h, bp["attn"], n_h, n_kv, cfg.hd, cfg.qkv_bias)
    if mesh is not None:
        q, k, v = _gather_heads(mesh, q, k, v)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    cache = cache_update(cache, k, v, pos, window, mesh=kv_mesh)
    att = attention_decode(q, cache, cfg.n_heads, mesh=kv_mesh)
    if mesh is not None:
        r = mesh.model_rank
        att = att[:, :, r * n_h:(r + 1) * n_h]
    x = x + parallel.reduce_from_model(
        mesh, att.reshape(b, 1, -1) @ bp["attn"]["wo"])
    if cross is not None:
        h = apply_norm(x, bp["norm_x"], cfg.norm)
        q = (h @ bp["cross"]["wq"]).reshape(b, 1, n_h, cfg.hd)
        att = (attention_decode(q, cross, n_h) if mesh is None
               else attention_decode_heads(q, cross, mesh))
        x = x + parallel.reduce_from_model(
            mesh, att.reshape(b, 1, -1) @ bp["cross"]["wo"])
    return _ffn(x, bp, cfg, mesh)[0]


def _ssm_layer_decode(x: torch.Tensor, bp: dict, cfg: ArchConfig,
                      ssm_cache: dict, layer: int, mesh=None) -> torch.Tensor:
    """One SSD block on one token; writes the layer's conv tail and state
    (this rank's block of them under a model axis) into ``ssm_cache``."""
    h = apply_norm(x, bp["norm1"], cfg.norm)
    conv, state = ssm_cache["conv"], ssm_cache["state"]
    y, conv_n, state_n = ssd_lib.ssm_block_step(h, bp["ssm"], cfg,
                                                conv[layer], state[layer],
                                                mesh)
    conv[layer] = conv_n
    state[layer] = state_n
    return x + y


def decode_step(params: Params, cfg: ArchConfig, token: torch.Tensor,
                cache: dict, *, window: int = 0, mesh=None
                ) -> tuple[torch.Tensor, dict]:
    """One serving step: token (B,1) int -> (logits (B,Vp) f32, cache).

    The cache's tensors are updated in place; the returned dict holds them
    with ``pos`` advanced by one.  The hybrid applies its shared block
    (site s writes K/V site s) before each run of ``attn_every`` SSD
    blocks, as the reference's ``_hybrid_decode``.  The audio decoder adds
    ``dec_pos[min(pos, max_position - 1)]`` to the token and attends to
    every one of the encoder's slots in each block.

    ``mesh`` with a model axis P > 1: ``params`` and ``cache`` are this
    rank's (:func:`init_cache`, :func:`prefill`), the blocks run as the
    module docstring says, and every rank returns the whole (B, Vp)
    logits, the same bits on each.
    """
    _check_arch(cfg)
    tp = model_axis_mesh(cfg, mesh)
    x = (params["embed"][token] if tp is None               # (B,1,D)
         else _embed_tp(params["embed"], token, tp))
    pos = int(cache["pos"])
    b = token.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    blocks = layer_params(params)
    if cfg.arch_type in _ATTN:
        k_all, v_all = cache["kv"]["k"], cache["kv"]["v"]
        cross = [None] * len(blocks)
        if cfg.arch_type == "audio":
            x = x + params["dec_pos"][min(pos, cfg.max_position - 1)]
            ck, cv = cache["cross_k"], cache["cross_v"]
            enc_len = torch.full((b,), ck.shape[3], dtype=torch.int32,
                                 device=x.device)
            cross = [KVCache(ck[i], cv[i], enc_len) for i in range(len(ck))]
        kv_mesh = _split_kv(cache, tp)
        for i, bp in enumerate(blocks):
            x = _attn_block_decode(x, bp, cfg,
                                   KVCache(k_all[i], v_all[i], None), pos,
                                   positions, window, cross[i], mesh=tp,
                                   kv_mesh=kv_mesh)
    else:
        period = cfg.attn_every or cfg.n_layers
        shared = subtree(params, "shared")
        kv_mesh = _split_kv(cache, tp) if "kv" in cache else None
        for i, bp in enumerate(blocks):
            if cfg.arch_type == "hybrid" and i % period == 0:
                site = i // period
                x = _attn_block_decode(
                    x, shared, cfg, KVCache(cache["kv"]["k"][site],
                                            cache["kv"]["v"][site], None),
                    pos, positions, window, mesh=tp, kv_mesh=kv_mesh)
            x = _ssm_layer_decode(x, bp, cfg, cache["ssm"], i, tp)
    x = apply_norm(x, subtree(params, "final_norm"), cfg.norm)
    logits = parallel.gather_columns(tp, logits_fn(params, cfg, x, tp)[:, 0])
    return logits, dict(cache, pos=pos + 1)


# ===========================================================================
# prefill
# ===========================================================================

def _cross_kv(enc: torch.Tensor, cross_p: dict, cfg: ArchConfig,
              n_h: int, n_kv: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_split_kv_from``: the encoder output's
    cross-attention K/V of ``n_kv`` kv heads (the rank's, under a model
    axis: ``cross_p`` holds its ``wk`` / ``wv`` columns), (B, S_enc, n_h,
    hd) expanded to its ``n_h`` query heads."""
    b, s, _ = enc.shape
    k = (enc @ cross_p["wk"]).reshape(b, s, n_kv, cfg.hd)
    v = (enc @ cross_p["wv"]).reshape(b, s, n_kv, cfg.hd)
    return _expand_kv(k, n_h), _expand_kv(v, n_h)


def _encode(params: Params, cfg: ArchConfig, frames: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """The audio family's encoder: the frame stub (B, S_enc, D) plus
    ``enc_pos``, the non-causal encoder blocks, ``enc_norm``.  Under a
    model axis (``mesh``) the blocks run on the rank's heads and MLP
    columns as dense blocks, and the output, the same on every rank,
    passes through ``copy_to_model``: each decoder block projects only
    the rank's heads' cross K/V from it, so its gradient is summed over
    the ranks once here, not once a block."""
    enc = frames.to(cfg.dtype) + params["enc_pos"][None, :frames.shape[1]]
    positions = torch.arange(enc.shape[1], device=enc.device)
    for bp in layer_params(params, "enc_blocks"):
        enc, _ = _attn_block_train(enc, bp, cfg, positions, causal=False,
                                   mesh=mesh)
    return parallel.copy_to_model(
        mesh, apply_norm(enc, subtree(params, "enc_norm"), cfg.norm))


def _write_cross(ck_dst: torch.Tensor, cv_dst: torch.Tensor,
                 ck: torch.Tensor, cv: torch.Tensor, mesh=None) -> None:
    """Write a decoder block's cross K/V (B, S_enc, heads, hd) into its
    cross cache (B, H, S_enc, hd); under a model axis (``mesh``) every
    head's, gathered from the ranks (the cross cache is whole on every
    rank)."""
    if mesh is not None:
        ck, cv = _gather_heads(mesh, ck, cv)
    ck_dst.copy_(ck.transpose(1, 2))
    cv_dst.copy_(cv.transpose(1, 2))


def _attn_prefill(x: torch.Tensor, bp: dict, cfg: ArchConfig,
                  positions: torch.Tensor, k_dst: torch.Tensor,
                  v_dst: torch.Tensor, enc: torch.Tensor | None = None,
                  ck_dst: torch.Tensor | None = None,
                  cv_dst: torch.Tensor | None = None, *, mesh=None,
                  kv_mesh=None) -> torch.Tensor:
    """One attention + FFN block over the prompt; writes its RoPE'd,
    un-expanded K/V into the first S slots of ``k_dst`` / ``v_dst``
    (B, Kv, S_cache, hd).  With ``enc`` (the audio decoder) the block
    cross-attends to the encoder output, whose K/V it writes into
    ``ck_dst`` / ``cv_dst`` (B, H, S_enc, hd).

    Under a model axis (``mesh``) the block runs head-parallel, as in
    training; every head's K/V is gathered and the rank writes all of them
    into its slots: the prompt's positions in its block of the cache
    (``kv_mesh``, the cache split on its slots) or all of them; every
    head's cross K/V is gathered into the whole cross cache."""
    b, s, _ = x.shape
    n_h, n_kv = local_heads(cfg.n_heads, cfg.n_kv_heads,
                            parallel.model_size(mesh))
    h = parallel.copy_to_model(mesh, apply_norm(x, bp["norm1"], cfg.norm))
    q, k, v = qkv_project(h, bp["attn"], n_h, n_kv, cfg.hd, cfg.qkv_bias)
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if mesh is None:
        k_dst[:, :, :s] = k.transpose(1, 2)
        v_dst[:, :, :s] = v.transpose(1, 2)
    else:
        k_all, v_all = _gather_heads(mesh, k, v)
        lo = 0 if kv_mesh is None else mesh.model_rank * k_dst.shape[2]
        n = min(max(s - lo, 0), k_dst.shape[2])
        k_dst[:, :, :n] = k_all[:, lo:lo + n].transpose(1, 2)
        v_dst[:, :, :n] = v_all[:, lo:lo + n].transpose(1, 2)
    att = attention_train(q, _expand_kv(k, n_h), _expand_kv(v, n_h),
                          causal=True, q_chunk=cfg.attn_q_chunk)
    x = x + parallel.reduce_from_model(
        mesh, att.reshape(b, s, -1) @ bp["attn"]["wo"])
    if enc is not None:
        x, ck, cv = _cross_train(x, bp, cfg, enc, mesh)
        _write_cross(ck_dst, cv_dst, ck, cv, mesh)
    return _ffn(x, bp, cfg, mesh)[0]


def _ssm_layer_prefill(x: torch.Tensor, bp: dict, cfg: ArchConfig,
                       ssm_cache: dict, layer: int, mesh=None) -> torch.Tensor:
    """One SSD block over the prompt; writes its conv tail and final state
    into ``ssm_cache`` (under a model axis its block of the tail's
    channels, of which every rank holds all, and its heads' state)."""
    h = apply_norm(x, bp["norm1"], cfg.norm)
    y, h_final, conv_tail = ssd_lib.ssm_block(h, bp["ssm"], cfg, mesh)
    conv = ssm_cache["conv"]
    conv[layer] = ssd_lib.conv_block(conv_tail, conv.shape[-1], mesh)
    ssm_cache["state"][layer] = h_final
    return x + y


def prompt_positions(cfg: ArchConfig, batch: dict) -> int:
    """Positions a prefill of ``batch`` takes, and so its cache's ``pos``:
    the tokens, after a vlm's patch prefix (audio frames go to the encoder
    and take none)."""
    s = batch["tokens"].shape[1]
    return s + batch["prefix"].shape[1] if cfg.arch_type == "vlm" else s


def prefill(params: Params, cfg: ArchConfig, batch: dict,
            cache_len: int | None = None, *, mesh=None
            ) -> tuple[torch.Tensor, dict]:
    """Process a full prompt; return (last-position logits (B,Vp) f32,
    decode cache).

    The K/V caches hold the prompt's RoPE'd, un-expanded K/V, padded with
    zeros to ``cache_len`` slots when ``cache_len`` exceeds the prompt and
    of the prompt's length otherwise, as the reference's.  Attention is the
    plain causal ``attention_train``, without a window, as in the
    reference.  SSD blocks leave their conv tails and final states (the
    reference's ``_prefill_ssm``); an ssm or hybrid prompt's length must be
    a multiple of ``min(cfg.ssm_chunk, S)``.

    ``batch["prefix"]`` is the modality stub: vlm (B, P, 1024) patch
    embeddings, projected by ``vis_proj`` and prepended, so that positions
    and ``pos`` run over P + S and the cache holds P + S slots (or
    ``cache_len``); audio (B, S_enc, D) frame embeddings, encoded once, the
    decoder tokens taking ``dec_pos`` and cross-attending to the encoder
    output, whose K/V go to ``cross_k`` / ``cross_v``.

    ``mesh`` with a model axis P > 1: ``params`` are this rank's shards
    (the vlm's patches projected on its ``vis_proj`` columns and gathered
    whole; the audio frames encoded head-parallel); the cache is this
    rank's block of it, with ``"slots"`` where it has K/V
    (:func:`init_cache`) and the cross cache whole, and every rank
    returns the whole logits.
    """
    _check_arch(cfg)
    tp = model_axis_mesh(cfg, mesh)
    tokens = batch["tokens"]
    x = (params["embed"][tokens] if tp is None              # (B,S,D)
         else _embed_tp(params["embed"], tokens, tp))
    if cfg.arch_type == "vlm":
        vis = parallel.gather_to_model(
            tp, batch["prefix"].to(cfg.dtype) @ params["vis_proj"])
        x = torch.cat([vis, x], 1)
    b, s = x.shape[0], prompt_positions(cfg, batch)
    dev = x.device
    positions = torch.arange(s, device=dev)
    s_cache = cache_len if cache_len is not None and cache_len > s else s
    cache: dict = {"pos": s}
    blocks = layer_params(params)
    if tp is not None and cfg.arch_type != "ssm":
        cache["slots"] = s_cache
    if cfg.arch_type in _ATTN:
        kv = cache["kv"] = _kv_cache(cfg, cfg.n_layers, b,
                                     local_slots(s_cache, tp), dev)
        kv_mesh = _split_kv(cache, tp)
        enc, ck, cv = None, [None] * len(blocks), [None] * len(blocks)
        if cfg.arch_type == "audio":
            enc = _encode(params, cfg, batch["prefix"], tp)
            x = x + params["dec_pos"][
                torch.clamp(positions, max=cfg.max_position - 1)][None]
            cache |= _cross_cache(cfg, b, enc.shape[1], dev)
            ck, cv = cache["cross_k"], cache["cross_v"]
        for i, bp in enumerate(blocks):
            x = _attn_prefill(x, bp, cfg, positions, kv["k"][i], kv["v"][i],
                              enc, ck[i], cv[i], mesh=tp, kv_mesh=kv_mesh)
    else:
        cache["ssm"] = _ssm_cache(cfg, b, dev, tp)
        period = cfg.attn_every or cfg.n_layers
        if cfg.arch_type == "hybrid":
            kv = cache["kv"] = _kv_cache(cfg, _n_sites(cfg), b,
                                         local_slots(s_cache, tp), dev)
            kv_mesh = _split_kv(cache, tp)
            shared = subtree(params, "shared")
        for i, bp in enumerate(blocks):
            if cfg.arch_type == "hybrid" and i % period == 0:
                site = i // period
                x = _attn_prefill(x, shared, cfg, positions, kv["k"][site],
                                  kv["v"][site], mesh=tp, kv_mesh=kv_mesh)
            x = _ssm_layer_prefill(x, bp, cfg, cache["ssm"], i, tp)
    x = apply_norm(x[:, -1:], subtree(params, "final_norm"), cfg.norm)
    logits = parallel.gather_columns(tp, logits_fn(params, cfg, x, tp)[:, 0])
    return logits, cache
