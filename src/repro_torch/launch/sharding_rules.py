"""Partition specs for params, optimizer states, caches and batches, and the
shards they describe.

Port of ``repro/launch/sharding_rules.py:34-168``.  The rules are the
reference's (Megatron-style tensor parallelism on "model", ZeRO-3 FSDP on
"data" for the archs with ``cfg.fsdp``):

  embed (V,D)            -> ("model", None)          vocab-parallel
  lm_head (D,V)          -> (fsdp, "model")
  attn  wq/wk/wv (D,HK)  -> (fsdp, "model")    wo (HK,D) -> ("model", fsdp)
  mlp   up/gate (D,F)    -> (fsdp, "model")  down (F,D) -> ("model", fsdp)
  MoE experts (E,D,F)    -> expert-parallel ("model" on E) when E divides the
                            model axis; otherwise tensor-parallel on F
  ssm in_proj (D,P)      -> (fsdp, "model")  out_proj -> ("model", fsdp)
  norms / scalars        -> replicated

Stacked blocks carry a leading L axis, so their specs take a leading None.
KV caches shard the batch on "data" (when it divides) and the cache's
sequence axis on "model".

A spec is a tuple with one entry per dim of its leaf: an axis name
(``"model"``, ``"data"``, or a tuple of names for a batch over
("pod", "data")) or ``None``; the reference's ``PartitionSpec`` is the
same tuple.  Spec trees are keyed as the port keys its trees: flat leaf
paths for params (``"blocks/attn/wq"``), the nested dicts of a decode
cache, the optimizer's state tuples.  A mesh is anything with
``axis_names`` and either a ``shape`` dict (the port's
:class:`repro_torch.launch.mesh.Mesh`) or ``devices`` of the mesh's shape
(the reference's ``jax.sharding.Mesh``, or a stand-in for it).

In place of the reference's ``place`` (``jax.device_put`` onto named
shardings), :func:`shard` cuts the block of a tensor that one rank keeps,
and :func:`unshard` puts the blocks of every rank back together.  The rules
cover every arch; the port's model axis trains and serves the dense family
(ROADMAP A12, A12b) and the moe, ssm, hybrid, vlm and audio families
(A12c), which read the dense rules, the MoE ones (the experts on "model"
when P divides E, each expert whole on its rank, else each expert's F
split as the dense MLP's; the router whole), ``vis_proj``'s column
blocks, the SSD ones (``in_proj`` column blocks, ``out_proj`` row blocks,
the rest whole), the audio ones (``enc_blocks`` as the dense blocks, the
cross-attention's ``wq`` / ``wk`` / ``wv`` column blocks and ``wo`` row
blocks, ``enc_pos`` / ``dec_pos`` whole) and the caches' (K/V split on
the slots, the SSD conv tails on their channels, the states on their
heads, the audio family's cross K/V whole).
"""
from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.optim.optimizers import AdamWState, SGDMState, SGDState
from repro_torch.parallel import model_dim  # noqa: F401  (the specs' API)

Spec = tuple
Tree = Any


def axis_sizes(mesh) -> dict:
    """Axis name -> size of ``mesh``."""
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, dict):
        return dict(shape)
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _axis_size(mesh, name: str) -> int:
    return axis_sizes(mesh).get(name, 1)


def _fit(spec: list, ndim: int) -> Spec:
    """Trim or pad ``spec`` with None to ``ndim`` entries."""
    out = list(spec)[:ndim]
    return tuple(out + [None] * (ndim - len(out)))


def param_specs(cfg: ArchConfig, params: dict, mesh) -> dict[str, Spec]:
    """Spec of every leaf of the flat ``params`` (tensors, on any device
    or the meta device), from its path."""
    fsdp = "data" if cfg.fsdp else None
    model_n = _axis_size(mesh, "model")
    expert_parallel = cfg.n_experts > 0 and cfg.n_experts % model_n == 0

    def rule(path: str, ndim: int) -> Spec:
        names = path.split("/")
        name = names[-1]
        stacked = names[0] in ("blocks", "enc_blocks")
        under_expert = "experts" in names

        def wrap(*spec):
            """Prefix the stacked-layer None (and the expert dim)."""
            out = list(spec)
            if under_expert:
                out = ["model" if expert_parallel else None] + out
            if stacked:
                out = [None] + out
            return _fit(out, ndim)

        if name == "embed":
            return ("model", None)
        if name == "lm_head":
            return (fsdp, "model")
        if name == "vis_proj":
            return (None, "model")
        if name in ("enc_pos", "dec_pos"):
            return (None, None)
        if name in ("wq", "wk", "wv"):
            return wrap(fsdp, "model")
        if name == "wo":
            return wrap("model", fsdp)
        if name in ("bq", "bk", "bv"):
            return wrap("model")
        if name in ("w_gate", "w_up"):
            if under_expert and expert_parallel:
                return wrap(fsdp, None)
            return wrap(fsdp, "model")
        if name == "w_down":
            if under_expert and expert_parallel:
                return wrap(None, fsdp)
            return wrap("model", fsdp)
        if name == "b_up":
            if under_expert and expert_parallel:
                return wrap(None)
            return wrap("model")
        if name == "router":
            return wrap(fsdp, None)
        if name == "in_proj":
            return wrap(fsdp, "model")
        if name == "out_proj":
            return wrap("model", fsdp)
        # norms, biases, conv weights, ssm scalars, everything small
        return wrap()

    return {k: rule(k, v.dim()) for k, v in params.items()}


def opt_state_specs(param_spec_tree: dict, opt_state) -> Tree:
    """Optimizer-state specs: moments take the param specs, the step ()."""
    if isinstance(opt_state, AdamWState):
        return AdamWState((), param_spec_tree, param_spec_tree)
    if isinstance(opt_state, SGDMState):
        return SGDMState((), param_spec_tree)
    return SGDState(())


def batch_specs(cfg: ArchConfig, batch: dict, mesh,
                include_pod: bool = True) -> dict[str, Spec]:
    """Token batches: the batch axis over ("pod", "data") when it divides."""
    dp = _axis_size(mesh, "data")
    pods = _axis_size(mesh, "pod") if include_pod else 1
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if b % (dp * pods) == 0:
            ax = ("pod", "data") if (pods > 1 and include_pod) else "data"
        elif b % dp == 0:
            ax = "data"
        else:
            ax = None
        out[k] = (ax, *([None] * (len(v.shape) - 1)))
    return out


def cache_specs(cfg: ArchConfig, cache: dict, mesh) -> dict:
    """Decode-cache specs, in the nested layout of the port's cache
    (``pos``, ``kv`` / ``ssm`` groups, the audio family's ``cross_k`` /
    ``cross_v``; a host int such as ``pos`` or ``slots`` takes ``()``).
    The K/V of a P = 1 cache's spec cut by :func:`shard` is the block that
    ``transformer.init_cache`` / ``prefill`` give a rank under the mesh."""
    dp = _axis_size(mesh, "data")
    model_n = _axis_size(mesh, "model")

    def rule(name: str, leaf) -> Spec:
        if name == "pos" or not isinstance(leaf, torch.Tensor):
            return ()
        shape = tuple(leaf.shape)
        b_ax = "data" if len(shape) >= 2 and shape[1] % dp == 0 else None
        if name in ("k", "v"):                    # (L, B, Kv, S, hd)
            s_ax = "model" if shape[3] % model_n == 0 else None
            return (None, b_ax, None, s_ax, None)
        if name in ("cross_k", "cross_v"):        # (L, B, H, Senc, hd)
            return (None, b_ax, None, None, None)
        if name == "conv":                        # (L, B, K-1, C)
            c_ax = "model" if shape[3] % model_n == 0 else None
            return (None, b_ax, None, c_ax)
        if name == "state":                       # (L, B, H, P, N)
            h_ax = "model" if shape[2] % model_n == 0 else None
            return (None, b_ax, h_ax, None, None)
        return (None,) * len(shape)

    def walk(node):
        return {k: walk(v) if isinstance(v, dict) else rule(k, v)
                for k, v in node.items()}
    return walk(cache)


def ef_specs(param_spec_tree: dict, fl_ax: str | None = None
             ) -> dict[str, Spec]:
    """Error-memory specs.  With ``fl_ax`` (the stacked ``(n_fl, *leaf)``
    memory of :func:`repro_torch.launch.steps.init_ef_tree`) the leading
    FL-device dim is sharded over ``fl_ax`` and each param dim keeps its
    layout, shifted right by one; without, the param specs."""
    if fl_ax is None:
        return param_spec_tree
    return {k: (fl_ax, *(ax if ax != fl_ax else None for ax in s))
            for k, s in param_spec_tree.items()}


# ---------------------------------------------------------------------------
# the shards a spec describes
# ---------------------------------------------------------------------------

def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def is_sharded(spec: Spec, sizes: dict) -> bool:
    """Whether any dim of ``spec`` is split over an axis of size > 1."""
    return any(sizes.get(a, 1) > 1 for e in spec for a in _names(e))


def _coords(sizes: dict, rank: int) -> dict:
    """Rank ``rank``'s index along each axis of a mesh of ``sizes`` (ranks
    in row-major mesh order)."""
    out = {}
    for name in reversed(list(sizes)):
        out[name] = rank % sizes[name]
        rank //= sizes[name]
    return out


def _block(spec: Spec, sizes: dict, coords: dict
           ) -> list[tuple[int, int]]:
    """(blocks along the dim, this rank's block index) of every dim: the
    dim's axes in their order, the first the slowest."""
    out = []
    for entry in spec:
        n, idx = 1, 0
        for a in _names(entry):
            n, idx = n * sizes.get(a, 1), idx * sizes.get(a, 1) + coords.get(
                a, 0)
        out.append((n, idx))
    return out


def shard(tensor: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The block of ``tensor`` that this rank of ``mesh`` keeps: the
    contiguous ``1/n`` of every dim split n ways, as a contiguous copy
    (the full tensor when nothing is split)."""
    if len(spec) != tensor.dim():
        raise ValueError(f"spec {spec} has {len(spec)} entries for a "
                         f"{tensor.dim()}-dim tensor")
    sizes = axis_sizes(mesh)
    out = tensor
    for dim, (n, idx) in enumerate(_block(spec, sizes,
                                          _coords(sizes, int(mesh.rank)))):
        if n == 1:
            continue
        if out.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(tensor.shape)} does not "
                             f"split {n} ways (spec {spec})")
        step = out.shape[dim] // n
        out = out.narrow(dim, idx * step, step)
    return out.contiguous() if out is not tensor else tensor


def unshard(shards: list, spec: Spec, sizes: dict | None = None
            ) -> torch.Tensor:
    """The tensor whose blocks are ``shards``, one per rank in rank order
    of a mesh of ``sizes`` (axis name -> size; by default a model axis of
    ``len(shards)``): the inverse of :func:`shard`."""
    sizes = dict(sizes) if sizes is not None else {"model": len(shards)}
    if math.prod(sizes.values()) != len(shards):
        raise ValueError(f"{len(shards)} shards for a mesh of {sizes}")
    first = shards[0]
    blocks = _block(spec, sizes, {a: 0 for a in sizes})
    full = [d * n for d, (n, _) in zip(first.shape, blocks)]
    out = torch.empty(full, dtype=first.dtype, device=first.device)
    for rank, piece in enumerate(shards):
        coords = _coords(sizes, rank)
        view = out
        for dim, (n, idx) in enumerate(_block(spec, sizes, coords)):
            step = piece.shape[dim]
            view = view.narrow(dim, idx * step, step)
        view.copy_(piece)
    return out


def shard_tree(tree: dict, specs: dict, mesh) -> dict:
    """:func:`shard` of every tensor leaf of a tree by its spec: a flat
    tree (params), or nested dicts such as a decode cache under
    :func:`cache_specs`, whose other leaves (``pos``) stay as they are."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = shard_tree(v, specs[k], mesh)
        elif isinstance(v, torch.Tensor):
            out[k] = shard(v, specs[k], mesh)
        else:
            out[k] = v
    return out
