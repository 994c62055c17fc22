"""AdamW on trees of tensors.

Port of ``repro/optim/optimizers.py:20-110`` and ``:137-141``: the parts
the DDPG controller (:mod:`repro_torch.core.controller`) runs.  A tree is
a tensor or a dict / list / tuple of trees; states are trees shaped like
the parameters, with f32 moments.

The arithmetic is XLA:CPU's for the reference's jitted step, so that one
step from the same gradients gives bitwise the reference's moments and
parameters (tests/test_torch_controller.py):

* each ``a * b + c * d`` is a fused multiply-add of the first product
  (``prng.fma32(a, b, c * d)``), as LLVM contracts it;
* ``(m / bc1) / (sqrt(v / bc2) + eps)`` is ``m / (bc1 * (...))``, XLA's
  algebraic rewrite of a division by a quotient, and the square root the
  correctly rounded one (``prng.sqrt_f32``; ATen's f32 ``sqrt`` is not);
* :func:`adamw_apply` is :func:`adamw_update` followed by
  :func:`apply_updates` as XLA fuses them: ``fma(-lr, x, p)``.

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

from repro_torch.core.prng import fma32, sqrt_f32

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


def adamw_init(params: Tree) -> AdamWState:
    return AdamWState(0, tree_map(torch.zeros_like, params),
                      tree_map(torch.zeros_like, params))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum, leaf by leaf in the reference's order, of each
    leaf's sum of squares."""
    leaves = tree_leaves(tree)
    total = torch.sum(torch.square(leaves[0].float()))
    for x in leaves[1:]:
        total = total + torch.sum(torch.square(x.float()))
    return sqrt_f32(total)


def _clip(grads: Tree, max_norm: float) -> Tree:
    """Scale ``grads`` by min(1, max_norm / (||grads|| + 1e-9)), on the
    device (no read-back)."""
    scale = torch.clamp(max_norm / (global_norm(grads) + 1e-9), max=1.0)
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
                 params: Tree) -> tuple[Tree, AdamWState]:
    """One AdamW step: (updates, new state); the gradients clipped to a
    global norm of ``cfg.grad_clip`` first."""
    grads = _clip(grads, cfg.grad_clip)
    step = np.asarray(state.step) + 1
    lr = _schedule(cfg, np.asarray(state.step))

    def upd(g, m, v, p):
        x, m2, v2 = _moments(cfg, g, m, v, p, step)
        return (-(_per_row(lr, x) * x)).to(p.dtype), m2, v2
    leaves = tree_map(upd, grads, state.m, state.v, params)
    step = int(step) if np.ndim(step) == 0 else step
    return _pick(leaves, 0), AdamWState(step, _pick(leaves, 1),
                                        _pick(leaves, 2))


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
        neg_lr = _per_row(-lr, x).expand_as(x)
        return fma32(neg_lr, x, p.float()).to(p.dtype), m2, v2
    leaves = tree_map(upd, grads, state.m, state.v, params)
    step = int(step) if np.ndim(step) == 0 else step
    return _pick(leaves, 0), AdamWState(step, _pick(leaves, 1),
                                        _pick(leaves, 2))
