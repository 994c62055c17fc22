"""Top-k Mixture-of-Experts layer (OLMoE: 64 SwiGLU experts, top-8;
Grok-1: 8 GeGLU experts, top-2).

Port of ``repro/models/moe.py``.  The dispatch is the reference's
sort-based, capacity-limited one:

  1. router top-k -> (token, expert, gate) triples, N*K rows;
  2. a STABLE sort by expert id; each row's position in its expert's
     segment from the segment starts (``searchsorted``);
  3. the rows gathered into an (E, C, D) buffer of capacity
     C = max(1, int(N*K / E * capacity_factor)); a row past its expert's
     capacity goes to the drop slot E*C and contributes nothing;
  4. the experts' MLPs as batched products (E, C, D) x (E, D, F), of any
     ``mlp_forward`` kind;
  5. each row's output gathered back and combined with the gate weights.

At decode (N = B tokens) the capacity is small: olmoe at batch 8 has
N*K = 64 rows over 64 experts, so C = 1 and each expert keeps only the
first of its rows in the stable expert-sorted order.  That is the
reference's semantics and the port keeps it.  grok-1 at batch 8 has
N*K = 16 rows over 8 experts, so C = int(16 / 8 * 1.25) = 2; its prefill
of 8 x 4096 tokens has C = 10,240.

``moe_dense_ref`` is the O(N*E) oracle (every expert on every token); it
drops nothing, so it equals ``moe_forward`` only where no row is dropped.

Under a model axis of P > 1 ranks (``mesh=``, ROADMAP A12c) the layer
runs on each rank's shards of the experts (``launch.sharding_rules``),
which is what the reference's ``shard_buffer`` constraint on the (E, C,
D) buffer asks of GSPMD.  The dispatch stays global: the block's input
is replicated and every rank runs the whole router, top-k, sort and
capacity over all N*K rows, so the drops are the reference's.  When P
divides E the experts are expert-parallel: rank r gathers only its
slots' rows (its E / P experts' block of the buffer), runs its own
experts whole and combines only the rows whose destination lies in its
block; otherwise each expert's ``w_gate`` / ``w_up`` are split on their
F columns and ``w_down`` on its F rows, as the dense MLP's, and every
rank runs every expert on its block of F.  Either way the rank's
combine is a partial of the output, summed over the ranks in f32 before
the one cast to x's dtype (the reference's f32 combine, then its cast),
and the input's gradient is summed over them
(``parallel.copy_to_model``).  The router is replicated but each rank's
gates reach the loss only through its own rows, so its gradient is
partial (``transformer.split_use_leaves`` sums it); the load-balance
loss, which every rank computes whole, has its gradient divided by P
(``parallel.count_once``), so that those SUMs count it once.
"""
from __future__ import annotations

import torch

from repro_torch import parallel
from repro_torch.core import prng
from .layers import _split_each, mlp_forward, mlp_init, normal


def moe_init(keys: list | None, lead: tuple, d: int, n_experts: int,
             d_expert: int, kind: str, dtype, device) -> dict:
    """``moe.moe_init`` for every row of the stacked prefix ``lead``: each
    key split into (router, experts); the router ``normal * d**-0.5`` kept
    in f32; the experts' key split ``n_experts`` ways, each expert an
    ``mlp_init`` (leaves of shape ``lead + (E, ...)``)."""
    kr, ke = _split_each(keys, 2)
    expert_keys = None
    if ke is not None:
        expert_keys = [k for key in ke for k in prng.split(key, n_experts)]
    return {
        "router": normal(kr, lead, (d, n_experts), d ** -0.5, torch.float32,
                         device),
        "experts": mlp_init(expert_keys, lead + (n_experts,), d, d_expert,
                            kind, dtype, device),
    }


def topk_stable(x: torch.Tensor, k: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, ties broken
    toward the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router(x2: torch.Tensor, w: torch.Tensor, k: int
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2: (N, D) -> gates (N, K) f32, ids (N, K), the Switch-style aux
    load-balance loss E * sum_e f_e * p_e."""
    logits = x2.to(torch.float32) @ w                      # (N, E)
    probs = torch.softmax(logits, -1)
    gates, ids = topk_stable(probs, k)
    gates = gates / gates.sum(-1, keepdim=True)
    e = w.shape[1]
    density = torch.nn.functional.one_hot(ids, e).to(torch.float32).mean(
        (0, 1))
    aux = e * torch.sum(density * probs.mean(0))
    return gates, ids, aux


def expert_mlps(buf: torch.Tensor, experts: dict, kind: str) -> torch.Tensor:
    """The reference's ``vmap(mlp_forward)`` over experts: buf (E, C, D),
    weights (E, D, F) / (E, F, D) -> (E, C, D).  ``mlp_forward``'s products
    are batched over the leading expert axis as they stand; only the plain
    ``gelu`` MLP's biases (E, F) / (E, D) take an axis for the C rows."""
    return mlp_forward(buf, {k: v[:, None] if k.startswith("b_") else v
                             for k, v in experts.items()}, kind)


def dispatch(ids: torch.Tensor, n_experts: int, capacity_factor: float
             ) -> tuple:
    """The global capacity-limited dispatch of the (N, K) expert ids:
    (order, the stable sort's permutation by expert; stok, each sorted
    row's source token; valid, whether it is within its expert's
    capacity; dest, its slot in the (E * C,) buffer or the drop slot
    E * C; C)."""
    n, top_k = ids.shape
    nk = n * top_k
    dev = ids.device
    flat_e = ids.reshape(nk)                               # expert of each row
    flat_tok = torch.arange(nk, device=dev) // top_k       # its source token
    se, order = torch.sort(flat_e, stable=True)            # stable by expert
    stok = flat_tok[order]

    # position of each row within its expert's segment
    starts = torch.searchsorted(se, torch.arange(n_experts, device=dev))
    pos = torch.arange(nk, device=dev) - starts[se]
    cap = max(1, int(nk / n_experts * capacity_factor))
    valid = pos < cap
    dest = torch.where(valid, se * cap + pos,
                       torch.full_like(se, n_experts * cap))
    return order, stok, valid, dest, cap


def moe_forward(x: torch.Tensor, p: dict, *, n_experts: int, top_k: int,
                capacity_factor: float = 1.25, mlp_kind: str = "swiglu",
                mesh=None) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux loss f32 scalar).
    ``mesh`` with a model axis P > 1: ``p`` holds this rank's shards of
    the experts and the whole router (module docstring)."""
    b, s, d = x.shape
    n = b * s
    dev = x.device
    tp = mesh if parallel.model_size(mesh) > 1 else None
    # this rank's experts [e0, e0 + n_loc), as its shards hold them: all
    # of them at P = 1 and when each expert's F is split
    n_loc = p["experts"]["w_up"].shape[0]
    e0 = 0 if n_loc == n_experts else tp.model_rank * n_loc
    if tp is not None and n_loc == n_experts and mlp_kind == "gelu":
        raise NotImplementedError(
            "biased GELU experts split on F under a model axis are not "
            "ported (no config has them): P must divide n_experts")
    x2 = parallel.copy_to_model(tp, x).reshape(n, d)
    gates, ids, aux = _router(x2, p["router"], top_k)
    order, stok, valid, dest, cap = dispatch(ids, n_experts,
                                             capacity_factor)
    nk = n * top_k
    drop = n_experts * cap

    # slot -> source token (row n of x2p is zeros); the drop slot is cut off
    slot_src = torch.full((drop + 1,), n, dtype=torch.int64, device=dev)
    slot_src[dest] = stok
    x2p = torch.cat([x2, x2.new_zeros((1, d))], 0)
    buf = x2p[slot_src[e0 * cap:(e0 + n_loc) * cap]].reshape(n_loc, cap, d)
    out_buf = expert_mlps(buf, p["experts"], mlp_kind)     # (E_loc, C, D)

    rows = out_buf.reshape(n_loc * cap, d)
    local = dest - e0 * cap
    mine = valid if n_loc == n_experts else (
        valid & (local >= 0) & (local < n_loc * cap))
    picked = torch.where(mine[:, None],
                         rows[torch.clamp(local, 0, n_loc * cap - 1)],
                         rows.new_zeros(()))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(nk, device=dev)
    per_slot = picked[inv].reshape(n, top_k, d)            # token-major
    y = torch.einsum("nkd,nk->nd", per_slot.to(torch.float32), gates)
    if tp is not None:
        y = parallel.reduce_from_model(tp, y)
        aux = parallel.count_once(tp, aux)
    return y.to(x.dtype).reshape(b, s, d), aux


def moe_dense_ref(x: torch.Tensor, p: dict, *, n_experts: int, top_k: int,
                  mlp_kind: str = "swiglu"
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """O(N*E) oracle: run every expert on every token, weight by gates."""
    b, s, d = x.shape
    x2 = x.reshape(-1, d)
    gates, ids, aux = _router(x2, p["router"], top_k)
    experts = p["experts"]
    all_out = torch.stack([
        mlp_forward(x2, {k: v[e] for k, v in experts.items()}, mlp_kind)
        for e in range(n_experts)], 1)                     # (N, E, D)
    w = torch.zeros((x2.shape[0], n_experts), dtype=torch.float32,
                    device=x.device)
    w.scatter_add_(1, ids, gates)
    y = torch.einsum("ne,ned->nd", w, all_out.to(torch.float32))
    return y.to(x.dtype).reshape(b, s, d), aux
