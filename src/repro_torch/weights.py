"""Carry parameters and decode caches between the JAX reference and the
port.

A reference parameter tree is a nested dict of arrays.  The port keeps a
flat ``dict[str, Tensor]`` whose keys are the tree's leaf paths joined by
``/`` (``"blocks/attn/wq"``), in the order of
``jax.tree_util.tree_leaves_with_path`` (sorted dict keys).  A flat vector
of the simulator (an error memory, an anchor) is one f32 array on both
sides (``vector_from_jax``).  This module
works on numpy arrays only: the caller turns jax arrays into numpy
(``np.asarray`` / ``jax.device_get``) on its side.  ``population_from_jax``
carries a reference population's state (EF store, chain carries, spend,
participation) into a port population.
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
    """A reference decode cache of numpy arrays -> the port's: ``pos`` as a
    host int, the ``kv`` tensors (``k`` / ``v``, ``(L, B, Kv, S, hd)``),
    the ``ssm`` ones (``conv`` ``(L, B, K-1, C)`` in the config's dtype,
    ``state`` ``(L, B, H, P, N)`` f32) and the audio family's ``cross_k`` /
    ``cross_v`` (``(L, B, H, S_enc, hd)``), whichever the cache has, in the
    same layout and dtypes."""
    out: dict = {"pos": int(np.asarray(tree["pos"]))}
    for group, names in (("kv", ("k", "v")), ("ssm", ("conv", "state"))):
        if group in tree:
            out[group] = {name: _to_tensor(tree[group][name]).to(device)
                          for name in names}
    for name in ("cross_k", "cross_v"):
        if name in tree:
            out[name] = _to_tensor(tree[name]).to(device)
    return out


def vector_from_jax(a, device: str | torch.device = "cpu") -> torch.Tensor:
    """A reference flat f32 vector (a device's error memory or anchor, a
    net progress delta) -> an f32 tensor of the same bits."""
    return _to_tensor(np.asarray(a, dtype=np.float32)).to(device)


# the host arrays of a fleet's state, by the reference FleetDDPG's names
DDPG_HOST = ("_buf_s", "_buf_a", "_buf_r", "_buf_s2", "_n", "_idx", "_n_act",
             "_n_train", "_sigma", "_last_s", "_last_a", "_has_last")
DDPG_NETS = ("actor", "critic", "actor_t", "critic_t")


def _flat_rows(layers) -> np.ndarray:
    """Stacked layers ``[{"w" (M, a, b), "b" (M, b)}, ...]`` -> (M, P) f32
    rows of w0, b0, w1, b1, ... (the port fleet's layout)."""
    parts = []
    for layer in layers:
        w, b = np.asarray(layer["w"]), np.asarray(layer["b"])
        parts += [w.reshape(w.shape[0], -1), b.reshape(b.shape[0], -1)]
    return np.concatenate(parts, 1).astype(np.float32)


def ddpg_from_jax(state: dict, fleet) -> None:
    """Load a reference ``FleetDDPG``'s state into the port's ``fleet`` (a
    :class:`repro_torch.core.controller.FleetDDPG` of the same M and
    config), in place.  ``state`` holds numpy arrays under the reference's
    attribute names: ``actor`` / ``critic`` / ``actor_t`` / ``critic_t``
    (lists of ``{"w", "b"}`` stacked on a leading M axis), ``opt_a`` /
    ``opt_c`` (``(step (M,), m, v)``, m and v shaped like the nets), and
    the :data:`DDPG_HOST` arrays (replay buffers, counters, noise scales,
    the last state / action)."""
    from repro_torch.optim.optimizers import AdamWState

    def rows(layers):
        return torch.from_numpy(_flat_rows(layers)).to(fleet.device)
    with fleet._on_stream():
        for k in DDPG_NETS:
            setattr(fleet, k, rows(state[k]))
        for k in ("opt_a", "opt_c"):
            step, m, v = state[k]
            setattr(fleet, k, AdamWState(np.array(step, np.int64), rows(m),
                                         rows(v)))
    for k in DDPG_HOST:
        cur = getattr(fleet, k)
        setattr(fleet, k, np.array(np.asarray(state[k]), dtype=cur.dtype))


def ddpg_to_jax(fleet) -> dict:
    """The port fleet's state in :func:`ddpg_from_jax`'s layout (numpy),
    so that one port fleet can be loaded from another (the card's from the
    CPU's) or compared with a reference fleet."""
    def layers(flat: torch.Tensor, name: str) -> list[dict]:
        out, o = [], 0
        a_np = flat.detach().cpu().numpy()
        sizes = fleet.sizes[name]
        for a, b in zip(sizes[:-1], sizes[1:]):
            w = a_np[:, o:o + a * b].reshape(-1, a, b)
            o += a * b
            out.append({"w": w, "b": a_np[:, o:o + b]})
            o += b
        return out
    out = {k: layers(getattr(fleet, k), k) for k in DDPG_NETS}
    for k, net in (("opt_a", "actor"), ("opt_c", "critic")):
        o = getattr(fleet, k)
        out[k] = (np.array(o.step, np.int32), layers(o.m, net),
                  layers(o.v, net))
    return out | {k: getattr(fleet, k).copy() for k in DDPG_HOST}


def population_from_jax(pop_ref, pop) -> None:
    """Load a reference ``Population``'s state into the port's ``pop`` (a
    :class:`repro_torch.core.population.Population` of the same N, D,
    store kind and channel count), in place and with the same dtypes: the
    store's arrays (to ``pop``'s device), the chain carries, the spend and
    the participation counts.  Both packages can then run on from one
    state."""
    src, dst = pop_ref.ef_store, pop.ef_store
    if src.name != dst.name or (src.n, src.d) != (dst.n, dst.d):
        raise ValueError(f"store {src.name} ({src.n}, {src.d}) does not fit "
                         f"{dst.name} ({dst.n}, {dst.d})")
    names = {"dense": ("_e",), "int8": ("_codes", "_scale"),
             "server": ("_e",)}[src.name]
    for k in names:
        a = np.asarray(getattr(src, k))
        setattr(dst, k, torch.from_numpy(a.copy()).to(dst.device))
    for k in ("carry_bw", "carry_good", "spend", "participation"):
        cur = getattr(pop, k)
        new = np.array(getattr(pop_ref, k), dtype=cur.dtype)
        if new.shape != cur.shape:
            raise ValueError(f"{k}: shape {new.shape} != {cur.shape}")
        setattr(pop, k, new)
