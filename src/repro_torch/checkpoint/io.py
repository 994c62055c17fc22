"""Checkpoints: trees of tensors -> a msgpack manifest + .npy blobs.

Port of ``repro/checkpoint/io.py`` in the same layout, so that each
package reads the other's files (tests/test_torch_checkpoint.py):

  <dir>/step_<N:08d>/manifest.msgpack  (leaf count, treedef, step, dtypes,
                                        shapes)
  <dir>/step_<N:08d>/arr_<i:05d>.npy   (one blob per leaf)

A tree is a leaf (a tensor, numpy array or Python scalar) or a dict, list
or tuple of trees; its leaves are taken in jax's order (dict
keys sorted) and its treedef is written as the string jax's
``str(treedef)`` gives the same structure.  A flat dict of ``/``-joined
paths (a port state dict), at any level of the tree, stands for the
nested dict of its paths, as ``weights.params_to_jax`` carries it
across.  bfloat16 leaves are stored
as uint16 views with a "bfloat16" tag (numpy has no bf16); Python-scalar
leaves of the template come back as Python scalars, everything else with
exactly the dtype it was saved with, on the template leaf's device.

Under a model axis (``save_checkpoint(..., mesh=, specs=)``) the ranks
hold shards: every leaf is gathered whole over the model group and rank 0
writes the files, in the format above, so that a checkpoint saved at
P = 2 loads at P = 1 (and in the reference).
"""
from __future__ import annotations

import os
import re

import numpy as np
import torch

from repro_torch import parallel

from . import msgpack


def _nest(tree):
    """A flat dict of "/"-joined paths as the nested dict it stands for."""
    if not (isinstance(tree, dict) and any(
            isinstance(k, str) and "/" in k for k in tree)):
        return tree
    out: dict = {}
    for path, leaf in tree.items():
        node = out
        *head, last = path.split("/")
        for name in head:
            node = node.setdefault(name, {})
        node[last] = leaf
    return out


def _flatten(tree) -> tuple[list, str]:
    """(leaves, treedef string) in jax's order and spelling."""
    leaves: list = []

    def walk(t) -> str:
        if isinstance(t, dict):
            t = _nest(t)
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if isinstance(t, tuple):
            kids = [walk(x) for x in t]
            return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
        if isinstance(t, list):
            return "[" + ", ".join(walk(x) for x in t) + "]"
        leaves.append(t)
        return "*"
    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(like, leaves: list):
    """``leaves`` in the structure of ``like`` (flat path dicts stay
    flat)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            nested = _nest(t)
            done = {k: build(nested[k]) for k in sorted(nested)}
            if nested is t:
                return {k: done[k] for k in t}
            return {k: _at(done, k) for k in t}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(like)


def _at(tree: dict, path: str):
    for name in path.split("/"):
        tree = tree[name]
    return tree


def _leaf_to_numpy(x) -> tuple[np.ndarray, str]:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.uint16).numpy(), "bfloat16"
        x = x.numpy()
    x = np.asarray(x)
    return x, str(x.dtype)


def _numpy_to_leaf(arr: np.ndarray, tag: str, like_leaf=None):
    """One leaf back, bit for bit, on the template leaf's device."""
    device = (like_leaf.device if isinstance(like_leaf, torch.Tensor)
              else "cpu")
    if tag == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr)).view(
            torch.bfloat16).to(device)
    if str(arr.dtype) != tag:
        raise ValueError(f"checkpoint blob dtype {arr.dtype} != manifest "
                         f"tag {tag!r} (corrupt checkpoint?)")
    if isinstance(like_leaf, (int, float)) and not isinstance(
            like_leaf, (np.generic, np.ndarray)) and arr.ndim == 0:
        return type(like_leaf)(arr.item())
    if isinstance(like_leaf, np.ndarray):
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def save_checkpoint(directory: str, step: int, tree, *, mesh=None,
                    specs: dict | None = None) -> str:
    """Write ``tree`` as step ``step`` under ``directory``; returns the
    step's path.  With ``mesh`` (a model axis above 1) ``tree`` is a flat
    dict of this rank's shards with ``specs`` (path -> spec, the leaves
    not named there replicated): each leaf is gathered whole on every
    rank, rank 0 writes, and every rank returns once the files exist."""
    path = os.path.join(directory, f"step_{step:08d}")
    if parallel.model_size(mesh) > 1:
        tree = {k: parallel.gather_model(mesh, v, (specs or {}).get(k, ()))
                for k, v in tree.items()}
        if mesh.rank == 0:
            save_checkpoint(directory, step, tree)
        mesh.group.barrier().wait()
        return path
    os.makedirs(path, exist_ok=True)
    leaves, treedef = _flatten(tree)
    manifest = {"n_leaves": len(leaves), "treedef": treedef,
                "step": step, "dtypes": [], "shapes": []}
    for i, leaf in enumerate(leaves):
        arr, tag = _leaf_to_numpy(leaf)
        manifest["dtypes"].append(tag)
        manifest["shapes"].append(list(arr.shape))
        np.save(os.path.join(path, f"arr_{i:05d}.npy"), arr)
    with open(os.path.join(path, "manifest.msgpack"), "wb") as f:
        f.write(msgpack.packb(manifest))
    return path


def load_checkpoint(directory: str, step: int, like):
    """Restore into the structure of ``like`` (a template tree)."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.msgpack"), "rb") as f:
        manifest = msgpack.unpackb(f.read())
    leaves_like, treedef = _flatten(like)
    if manifest["n_leaves"] != len(leaves_like):
        raise AssertionError(f"checkpoint has {manifest['n_leaves']} leaves, "
                             f"template has {len(leaves_like)}")
    if manifest.get("treedef") != treedef:
        raise ValueError(
            "checkpoint treedef does not match template structure "
            "(same leaf count, different tree) -- refusing to restore "
            "into the wrong pytree layout")
    leaves = []
    for i, (tag, tmpl) in enumerate(zip(manifest["dtypes"], leaves_like)):
        arr = np.load(os.path.join(path, f"arr_{i:05d}.npy"))
        want = list(tmpl.shape) if isinstance(
            tmpl, (torch.Tensor, np.ndarray)) else list(np.shape(tmpl))
        if manifest["shapes"][i] != want:
            raise ValueError(
                f"leaf {i}: checkpoint shape {manifest['shapes'][i]} != "
                f"template shape {want}")
        leaves.append(_numpy_to_leaf(arr, tag, tmpl))
    return _unflatten(like, leaves)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.match(r"step_(\d+)$", d))]
    return max(steps) if steps else None


def restore(directory: str, like):
    step = latest_step(directory)
    if step is None:
        return None, None
    return load_checkpoint(directory, step, like), step
