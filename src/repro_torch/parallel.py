"""The model axis's collectives (tensor parallelism, ROADMAP A12).

A mesh with a model axis P > 1 (:func:`repro_torch.launch.mesh.
make_host_mesh`) holds ``model_group``, the P ranks that split each leaf,
and ``model_rank``, this rank's place among them.  The collectives here
call ``model_group`` directly: :func:`copy_to_model` (identity forward,
all-reduce backward) and :func:`reduce_from_model` (all-reduce forward,
identity backward) are ``torch.autograd.Function`` s, Megatron's f and g;
:func:`all_reduce_max` and :func:`all_reduce_sum` carry no gradient (the
LGC statistics, the clip's norm); :func:`gather_model` rebuilds a whole
leaf on every rank (checkpoints, checks).

Serving (ROADMAP A12b) adds the all-gather: :func:`gather_ranks` stacks
every rank's tensor in rank order, without gradient (the ranks' partial
decode-attention states, which ``models.layers`` merges), and
:func:`gather_columns` puts the ranks' columns side by side (the token's
q / k / v, the vocab-parallel logits, the SSD blocks' ``in_proj``
output); its gradient is the sum over the model group of every rank's
gradient of the whole, cut to the rank's columns.  :func:`sum_over_model`
is a SUM whose gradient is summed too (the gated RMSNorm's sum of squares
over d_inner, split by heads), and :func:`all_reduce_sum_tensors` sums a
list of tensors in one collective (the SSD leaves held whole whose use
the heads split: their gradients are partial on each rank).

The moe and vlm families (A12c) add two: :func:`gather_to_model` puts
the ranks' columns side by side as :func:`gather_columns` does, for a
whole that every rank then uses the same way (the vlm's projected patch
prefix joins the replicated residual stream), so its gradient is the
rank's own columns of the whole's, without a collective; and
:func:`count_once` is the identity whose gradient is divided by P (the
MoE's load-balance loss, which every rank computes whole from the
replicated router, while the SUMs downstream of it add every rank's
gradient).

Each takes ``mesh=None`` (or a mesh whose model axis is 1) and then
returns its input as it is, so one code path serves the model at P = 1,
where it runs exactly the ops it ran before the model axis existed.

:data:`STATS` counts the calls, bytes (this rank's part) and seconds
inside them; with ``STATS["sync"]`` set, each call waits for the card
before and after, so the seconds are the collective's own (and the
caller's round pays two host waits a call).
"""
from __future__ import annotations

import time

import torch
import torch.distributed as dist

#: calls, bytes and seconds inside the model axis's collectives; ``sync``
#: makes each call wait for the card first, so its seconds are its own
STATS = {"calls": 0, "bytes": 0, "seconds": 0.0, "sync": False}


def model_size(mesh) -> int:
    """P, the ranks of ``mesh``'s model axis (1 without a mesh)."""
    return 1 if mesh is None else mesh.model_size


def model_dim(spec: tuple) -> int | None:
    """The dim ``spec`` (one entry per dim: an axis name, a tuple of
    names, or None) shards over "model", or None (the reference's
    ``steps._model_axis_of``)."""
    for i, entry in enumerate(spec):
        if entry == "model" or (isinstance(entry, tuple)
                                and "model" in entry):
            return i
    return None


def _collective(work, t: torch.Tensor) -> None:
    """Run the collective ``work()`` on ``t`` (this rank's part) to its
    end, and count it in :data:`STATS`."""
    if STATS["sync"] and t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    work().wait()
    if STATS["sync"] and t.is_cuda:
        torch.cuda.synchronize(t.device)
    STATS["seconds"] += time.perf_counter() - t0
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()


def _all_reduce(group, x: torch.Tensor, op) -> torch.Tensor:
    """All-reduce a contiguous copy of ``x`` over ``group`` with ``op``."""
    out = x.clone(memory_format=torch.contiguous_format)
    opts = dist.AllreduceOptions()
    opts.reduceOp = op
    _collective(lambda: group.allreduce([out], opts), out)
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.group, g, dist.ReduceOp.SUM), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(group, x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the model group (the input
    of a column-parallel matmul, whose ranks each give a partial
    gradient)."""
    if model_size(mesh) == 1:
        return x
    return _CopyToModel.apply(x, mesh.model_group)


def reduce_from_model(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every model rank's ``x`` (a row-parallel matmul's
    partial outputs); its gradient passes unchanged."""
    if model_size(mesh) == 1:
        return x
    return _ReduceFromModel.apply(x, mesh.model_group)


def all_reduce_max(mesh, x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of every model rank's ``x``; no gradient."""
    if model_size(mesh) == 1:
        return x
    return _all_reduce(mesh.model_group, x.detach(), dist.ReduceOp.MAX)


def all_reduce_sum(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every model rank's ``x``; no gradient."""
    if model_size(mesh) == 1:
        return x
    return _all_reduce(mesh.model_group, x.detach(), dist.ReduceOp.SUM)


def gather_model(mesh, x: torch.Tensor, spec: tuple) -> torch.Tensor:
    """The whole tensor of which ``x`` is this rank's block under ``spec``
    (``launch.sharding_rules.shard`` on a (1, P) mesh: the contiguous
    blocks of :func:`model_dim` in rank order), on every rank; ``x``
    itself when ``spec`` splits nothing or P is 1."""
    dim = model_dim(spec)
    if model_size(mesh) == 1 or dim is None:
        return x
    src = x.detach().contiguous()
    outs = [torch.empty_like(src) for _ in range(mesh.model_size)]
    mesh.model_group.allgather([outs], [src]).wait()
    return torch.cat(outs, dim)


def gather_ranks(mesh, x: torch.Tensor) -> torch.Tensor:
    """(P, *x.shape): every model rank's ``x`` stacked in rank order, the
    same on every rank; no gradient.  Without a model axis ``x[None]``."""
    if model_size(mesh) == 1:
        return x[None]
    src = x.detach().contiguous()
    outs = torch.empty((mesh.model_size,) + tuple(src.shape),
                       dtype=src.dtype, device=src.device)
    _collective(lambda: mesh.model_group.allgather(
        [list(outs.unbind(0))], [src]), src)
    return outs


class _GatherColumns(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.width = mesh, x.shape[-1]
        return torch.cat(gather_ranks(mesh, x).unbind(0), -1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.model_rank * ctx.width
        whole = _all_reduce(ctx.mesh.model_group, g, dist.ReduceOp.SUM)
        return whole[..., lo:lo + ctx.width].contiguous(), None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce(group, x, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(ctx.group, g, dist.ReduceOp.SUM), None


def gather_columns(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every model rank's ``x`` (..., c) side by side on the last dim in
    rank order: (..., P c), the same on every rank.  Every rank may use
    any part of the whole, so the gradient of this rank's ``x`` is its
    columns of the SUM over the ranks of the whole's gradients."""
    if model_size(mesh) == 1:
        return x
    return _GatherColumns.apply(x, mesh)


class _GatherToModel(_GatherColumns):
    @staticmethod
    def backward(ctx, g):
        lo = ctx.mesh.model_rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None


class _CountOnce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, p):
        ctx.p = p
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.p, None


def gather_to_model(mesh, x: torch.Tensor) -> torch.Tensor:
    """Every model rank's ``x`` (..., c) side by side on the last dim in
    rank order, as :func:`gather_columns`, for a whole that every rank
    uses the same way: each rank's gradient of the whole is then the
    whole gradient, and the gradient of its ``x`` is its own columns of
    it (Megatron's gather, whose backward is a split)."""
    if model_size(mesh) == 1:
        return x
    return _GatherToModel.apply(x, mesh)


def count_once(mesh, x: torch.Tensor) -> torch.Tensor:
    """``x`` as it is, its gradient divided by P: a term that every rank
    computes whole from replicated inputs and whose gradient the SUMs
    over the model group downstream of it would otherwise count P
    times."""
    if model_size(mesh) == 1:
        return x
    return _CountOnce.apply(x, mesh.model_size)


def sum_over_model(mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of every model rank's ``x``, where each rank then uses the
    sum in its own way (a statistic of a split dim): the sum's gradient
    differs between the ranks, so it is summed over them too (where
    :func:`reduce_from_model` passes it unchanged)."""
    if model_size(mesh) == 1:
        return x
    return _SumOverModel.apply(x, mesh.model_group)


def all_reduce_sum_tensors(mesh, tensors: list) -> list:
    """Each of ``tensors`` summed over the model group, in one collective
    (packed as f32, each cast back to its dtype); no gradient."""
    if model_size(mesh) == 1 or not tensors:
        return list(tensors)
    flat = all_reduce_sum(mesh, torch.cat(
        [t.detach().reshape(-1).to(torch.float32) for t in tensors]))
    return [piece.view(t.shape).to(t.dtype) for piece, t in zip(
        flat.split([t.numel() for t in tensors]), tensors)]
