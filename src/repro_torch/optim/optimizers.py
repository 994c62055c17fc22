"""AdamW, SGD-momentum and SGD on trees of tensors.

Port of ``repro/optim/optimizers.py``.  A tree is a tensor or a dict /
list / tuple of trees; states are trees shaped like the parameters: AdamW
keeps f32 moments whatever the parameter dtype, SGD-momentum a moment of
the parameter's dtype.

The arithmetic is XLA:CPU's for the reference's jitted step, so that one
step from the same gradients gives bitwise the reference's moments and
parameters (tests/test_torch_controller.py):

* each ``a * b + c * d`` is a fused multiply-add of the first product
  (``prng.fma32(a, b, c * d)``), as LLVM contracts it;
* ``(m / bc1) / (sqrt(v / bc2) + eps)`` is ``m / (bc1 * (...))``, XLA's
  algebraic rewrite of a division by a quotient, and the square root the
  correctly rounded one (``prng.sqrt_f32``; ATen's f32 ``sqrt`` is not);
* :func:`adamw_apply` is :func:`adamw_update` followed by
  :func:`apply_updates` as XLA fuses them: ``fma(-lr, x, p)`` for f32
  parameters (the update of a bf16 one is rounded to bf16 first);
* the gradient clip's global norm sums each leaf's squares in XLA:CPU's
  order (``prng.xla_sum_squares``), and its scale ``max_norm / (norm +
  1e-9)`` divides once (a tensor numerator: ``float / tensor`` in torch is
  a reciprocal and a multiply, two roundings).

Under a model axis (``get_optimizer(..., mesh=, specs=)``, ROADMAP A12)
the gradients are each rank's shards, and the clip's norm sums the
squares of the shards over the model group (:func:`global_norm`); that
sum's order is not XLA:CPU's, so the sharded step holds the reference at
a tolerance, not bitwise.  Everything else is elementwise on the shards.

The step count lives on the host (an int, or an int array of one count
per leading row of every leaf), so the bias corrections ``1 - beta **
step`` are host f32 values: ``beta ** step`` taken in f64 and rounded once
to f32, which equals XLA:CPU's f32 ``pow`` after the subtraction for the
steps the controller reaches (tests/test_torch_controller.py holds steps
1-200).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from repro_torch import parallel
from repro_torch.core.prng import fma32, sqrt_f32, xla_sum_squares
from repro_torch.kernels.ref import ftz

Tree = Any


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the tensor leaves of ``tree`` (and of the trees of the
    same structure in ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Tree) -> list[torch.Tensor]:
    """The leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


class AdamWState(NamedTuple):
    step: int | np.ndarray
    m: Tree
    v: Tree


class SGDMState(NamedTuple):
    step: int
    momentum: Tree


class SGDState(NamedTuple):
    step: int


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    momentum: float = 0.9
    grad_clip: float = 1.0
    warmup_steps: int = 100


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: Tree) -> AdamWState:
    return AdamWState(0, tree_map(_zeros32, params),
                      tree_map(_zeros32, params))


def sgdm_init(params: Tree) -> SGDMState:
    return SGDMState(0, tree_map(torch.zeros_like, params))


def sgd_init(params: Tree) -> SGDState:
    return SGDState(0)


def global_norm(tree: Tree, mesh=None, specs: dict | None = None
                ) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in the reference's order, of each
    leaf's sum of squares in XLA:CPU's order.

    With ``mesh`` (a model axis above 1) ``tree`` is a flat dict of this
    rank's shards and ``specs`` their specs: the squares of the split
    leaves are summed on each rank and then over the model group, those
    of the replicated leaves (a norm's scale, held whole by every rank)
    added once after; each leaf's squares in torch's order.  Not
    XLA:CPU's order (C8's bitwise norm cannot hold across shards): the
    norm agrees with the unsharded one at f32 rounding, a tolerance."""
    if parallel.model_size(mesh) > 1:
        split = [k for k in tree if parallel.model_dim(specs[k]) is not None]
        whole = [k for k in tree if k not in split]
        zero = torch.zeros((), dtype=torch.float32,
                           device=next(iter(tree.values())).device)

        def sq(keys):
            return sum((tree[k].float().square().sum() for k in keys), zero)
        return sqrt_f32(parallel.all_reduce_sum(mesh, sq(split)) + sq(whole))
    leaves = tree_leaves(tree)
    total = xla_sum_squares(leaves[0])
    for x in leaves[1:]:
        total = total + xla_sum_squares(x)
    return sqrt_f32(total)


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / (norm + 1e-9)) in f32, divided once."""
    t = norm + 1e-9
    return torch.clamp(torch.full_like(t, max_norm) / t, max=1.0)


def _clip(grads: Tree, max_norm: float, mesh=None,
          specs: dict | None = None) -> Tree:
    """Scale ``grads`` by :func:`clip_scale` of their global norm, on the
    device (no read-back)."""
    scale = clip_scale(global_norm(grads, mesh, specs), max_norm)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), grads)


def _schedule(cfg: OptimizerConfig, step) -> np.ndarray:
    """Linear warm-up to ``cfg.lr`` (f32, one per step count)."""
    warm = np.minimum(np.float32(1.0), (np.asarray(step, np.float32) + 1)
                      / np.float32(max(cfg.warmup_steps, 1)))
    return np.float32(cfg.lr) * warm


def _bias(beta: float, step) -> np.ndarray:
    """f32 ``1 - beta ** step``, as XLA:CPU's f32 pow gives it."""
    b = float(np.float32(beta))
    powers = np.array([b ** int(s) for s in np.atleast_1d(step)])
    return (np.float32(1.0) - powers.astype(np.float32)).reshape(
        np.shape(step))


def _per_row(values: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """Host f32 values as a tensor broadcasting against ``like``: a
    scalar, or one value per leading row."""
    t = torch.tensor(np.asarray(values, np.float32), device=like.device)
    return t.reshape(t.shape + (1,) * (like.dim() - t.dim()))


def _moments(cfg: OptimizerConfig, g, m, v, p, step
             ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x, m', v') of one leaf, x = m'_hat / (sqrt(v'_hat) + eps) + wd * p
    at the new ``step``."""
    b1, b2 = cfg.beta1, cfg.beta2
    gf = g.float()
    m2 = fma32(torch.full_like(m, b1), m, (1 - b1) * gf)
    v2 = fma32(torch.full_like(v, b2), v, ((1 - b2) * gf) * gf)
    bc1 = _per_row(_bias(b1, step), m2)
    bc2 = _per_row(_bias(b2, step), v2)
    x = m2 / (bc1 * (sqrt_f32(v2 / bc2) + cfg.eps))
    if cfg.weight_decay:
        x = fma32(torch.full_like(x, cfg.weight_decay), p.float(), x)
    return x, m2, v2


def _pick(tree: Tree, i: int) -> Tree:
    """Element ``i`` of the tuples at the leaves."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(t, i) for t in tree]
    return tree[i]


def adamw_update(cfg: OptimizerConfig, grads: Tree, state: AdamWState,
                 params: Tree, mesh=None, specs: dict | None = None
                 ) -> tuple[Tree, AdamWState]:
    """One AdamW step: (updates, new state); the gradients clipped to a
    global norm of ``cfg.grad_clip`` first (over the model group with
    ``mesh``)."""
    grads = _clip(grads, cfg.grad_clip, mesh, specs)
    step = np.asarray(state.step) + 1
    lr = _schedule(cfg, np.asarray(state.step))

    def upd(g, m, v, p):
        x, m2, v2 = _moments(cfg, g, m, v, p, step)
        return (-(_per_row(lr, x) * x)).to(p.dtype), m2, v2
    leaves = tree_map(upd, grads, state.m, state.v, params)
    step = int(step) if np.ndim(step) == 0 else step
    return _pick(leaves, 0), AdamWState(step, _pick(leaves, 1),
                                        _pick(leaves, 2))


def sgdm_update(cfg: OptimizerConfig, grads: Tree, state: SGDMState,
                params: Tree, mesh=None, specs: dict | None = None
                ) -> tuple[Tree, SGDMState]:
    """One SGD-momentum step on the clipped gradients: m' = beta * m + g
    (one fused multiply-add, kept in the moment's dtype), update -lr * m'
    in the gradient's dtype."""
    grads = _clip(grads, cfg.grad_clip, mesh, specs)
    lr = _schedule(cfg, state.step)

    def upd(g, mom):
        m2 = ftz(fma32(torch.full_like(g, cfg.momentum, dtype=torch.float32),
                       mom.float(), g.float())).to(mom.dtype)
        return ftz(_per_row(-lr, g) * m2.float()).to(g.dtype), m2
    leaves = tree_map(upd, grads, state.momentum)
    return _pick(leaves, 0), SGDMState(state.step + 1, _pick(leaves, 1))


def sgd_update(cfg: OptimizerConfig, grads: Tree, state: SGDState,
               params: Tree, mesh=None, specs: dict | None = None
               ) -> tuple[Tree, SGDState]:
    """One plain SGD step: -lr * g in the gradient's dtype, unclipped as
    in the reference."""
    lr = _schedule(cfg, state.step)
    updates = tree_map(
        lambda g: ftz(_per_row(-lr, g) * g.float()).to(g.dtype), grads)
    return updates, SGDState(state.step + 1)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: (p.float() + u.float()).to(p.dtype),
                    params, updates)


def adamw_apply(cfg: OptimizerConfig, grads: Tree, state: AdamWState,
                params: Tree, clipped: bool = False
                ) -> tuple[Tree, AdamWState]:
    """``apply_updates(params, adamw_update(...)[0])`` as XLA fuses the two:
    the new parameters ``fma(-lr, x, p)`` and the new state.  ``clipped``:
    the caller has clipped ``grads`` already."""
    if not clipped:
        grads = _clip(grads, cfg.grad_clip)
    step = np.asarray(state.step) + 1
    lr = _schedule(cfg, np.asarray(state.step))

    def upd(g, m, v, p):
        x, m2, v2 = _moments(cfg, g, m, v, p, step)
        if p.dtype != torch.float32:       # the update rounds to p's dtype
            u = (-(_per_row(lr, x) * x)).to(p.dtype)
            return (p.float() + u.float()).to(p.dtype), m2, v2
        neg_lr = _per_row(-lr, x).expand_as(x)
        return fma32(neg_lr, x, p.float()).to(p.dtype), m2, v2
    leaves = tree_map(upd, grads, state.m, state.v, params)
    step = int(step) if np.ndim(step) == 0 else step
    return _pick(leaves, 0), AdamWState(step, _pick(leaves, 1),
                                        _pick(leaves, 2))


def get_optimizer(name: str, cfg: OptimizerConfig | None = None, *,
                  mesh=None, specs: dict | None = None):
    """(init_fn, update_fn) for 'adamw' | 'sgdm' | 'sgd';
    ``update_fn(grads, state, params) -> (updates, state)``.  With
    ``mesh`` (a model axis) and the params' ``specs`` the trees are this
    rank's shards and the clip's norm spans the model group."""
    cfg = cfg or OptimizerConfig(name=name)
    updates = {"adamw": (adamw_init, adamw_update),
               "sgdm": (sgdm_init, sgdm_update),
               "sgd": (sgd_init, sgd_update)}
    if name not in updates:
        raise ValueError(name)
    init, update = updates[name]
    return init, lambda g, s, p: update(cfg, g, s, p, mesh, specs)
