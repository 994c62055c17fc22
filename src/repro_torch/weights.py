"""Carry parameters and decode caches between the JAX reference and the
port.

A reference parameter tree is a nested dict of arrays.  The port keeps a
flat ``dict[str, Tensor]`` whose keys are the tree's leaf paths joined by
``/`` (``"blocks/attn/wq"``), in the order of
``jax.tree_util.tree_leaves_with_path`` (sorted dict keys).  A flat vector
of the simulator (an error memory, an anchor) is one f32 array on both
sides (``vector_from_jax``).  This module
works on numpy arrays only: the caller turns jax arrays into numpy
(``np.asarray`` / ``jax.device_get``) on its side.
"""
from __future__ import annotations

import numpy as np
import torch


def _to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bf16: carry bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_jax(tree: dict, device: str | torch.device = "cpu"
                    ) -> dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> flat ``{path: Tensor}``."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}{k}/")
        else:
            out[prefix[:-1]] = _to_tensor(node).to(device)
    walk(tree, "")
    return out


def params_to_jax(params: dict[str, torch.Tensor]) -> dict:
    """Flat ``{path: Tensor}`` -> nested dict of numpy arrays (bf16 leaves
    come back as ml_dtypes bfloat16)."""
    tree: dict = {}
    for name, t in params.items():
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            arr = t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        else:
            arr = t.numpy()
        node[parts[-1]] = arr
    return tree


def cache_from_jax(tree: dict, device: str | torch.device = "cpu") -> dict:
    """A reference decode cache ``{"pos", "kv": {"k", "v"}}`` of numpy arrays
    -> the port's: ``pos`` as a host int, ``k`` / ``v`` as tensors of the
    same ``(L, B, Kv, S, hd)`` layout and dtype."""
    return {"pos": int(np.asarray(tree["pos"])),
            "kv": {name: _to_tensor(tree["kv"][name]).to(device)
                   for name in ("k", "v")}}


def vector_from_jax(a, device: str | torch.device = "cpu") -> torch.Tensor:
    """A reference flat f32 vector (a device's error memory or anchor, a
    net progress delta) -> an f32 tensor of the same bits."""
    return _to_tensor(np.asarray(a, dtype=np.float32)).to(device)
