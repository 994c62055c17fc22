"""Mamba2 SSD (state-space duality) block [arXiv:2405.21060].

Port of ``repro/models/ssd.py``.  Chunked-scan formulation: the sequence
is split into chunks of length Q; within a chunk the output is an
attention-like masked product, across chunks one recurrent state
(H, P, N) is carried, here by a loop over the S/Q chunks (the reference's
``lax.scan``).  ``ssd_step`` is the O(1) decode recurrence.

Shapes: x (B, S, D); heads H = d_inner / head_dim, head dim P, state N.
The dtypes are the reference's: the SSD core runs in f32 and returns y in
x's dtype and the state in f32; the causal conv adds its K products in
order 0..K-1 in the input dtype.

Under a model axis of P ranks (``mesh=``, ROADMAP A12c) a rank runs
H / P heads.  Its leaves are ``launch.sharding_rules``' blocks: contiguous
column blocks of ``in_proj`` (D, 2 di + 2 ns + nh), which do not line up
with heads (rank 0 of mamba2-370m at P = 2 holds z and x channels 0-143),
row blocks of ``out_proj`` (its heads' rows), and the rest whole.  So the
block gathers ``x @ in_proj``'s columns once (:func:`repro_torch.parallel.
gather_columns`) and takes its heads' z, x and dt and the whole B and C;
the conv, the scan and the D skip run on its heads; the gated RMSNorm
sums its squares over the ranks (:func:`layers.rmsnorm`'s ``mesh``), and
``out_proj``'s partial outputs are summed.  The leaves held whole but
used a head block at a time (:data:`SPLIT_USE`) get a partial gradient on
each rank, which the train steps sum over the ranks.  A decode step
convolves the channels of its block of the conv cache (``cache_specs``
splits C, not heads) and gathers the conv's output; a conv cache held
whole is convolved whole.  At P = 1 every function runs the ops it ran
before the model axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import parallel
from repro_torch.core import prng
from .layers import _split_each, normal, rmsnorm

NEG_MASK = -1e30
#: the SSD leaves held whole on every rank whose use the model axis splits
#: by heads (``conv_w`` / ``conv_b``: x's channels by head; B's and C's are
#: used by every head, each rank's giving part of their gradient)
SPLIT_USE = ("a_log", "conv_b", "conv_w", "d_skip", "dt_bias", "norm_scale")


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches to
    x above its threshold, another function)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def a_log_init(nh: int, device) -> torch.Tensor:
    """``jnp.log(jnp.linspace(1.0, 16.0, nh))`` bit for bit: XLA's linspace
    (``1 - i * r`` with r = f32(1 / (nh - 1)), then ``fma(i, 16 r, that)``,
    the last value 16 exactly) and XLA:CPU's log."""
    if nh == 1:
        lin = torch.ones(1, dtype=torch.float32, device=device)
    else:
        r = torch.tensor(1.0 / (nh - 1), dtype=torch.float32, device=device)
        i = torch.arange(nh - 1, dtype=torch.float32, device=device)
        head = prng.fma32(i, (16.0 * r).expand_as(i), 1.0 - i * r)
        lin = torch.cat([head, torch.full((1,), 16.0, device=device)])
    return prng._xla_log(lin)


def ssm_init(keys: list | None, lead: tuple, cfg, dtype, device) -> dict:
    """``ssd.ssm_init`` for every row of the stacked prefix ``lead``: each
    key split four ways (in_proj 0, conv_w 1, out_proj 3; 2 is unused)."""
    d, di, ns, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    ks = _split_each(keys, 4)
    c = di + 2 * ns
    d_in_proj = 2 * di + 2 * ns + nh      # z, x, B, C, dt

    def const(n, value, dt):
        return torch.full(lead + (n,), value, dtype=dt, device=device)
    a_log = torch.empty(lead + (nh,), dtype=torch.float32, device=device)
    if device.type != "meta":
        a_log[...] = a_log_init(nh, device)
    return {
        "in_proj": normal(ks[0], lead, (d, d_in_proj), d ** -0.5, dtype,
                          device),
        "conv_w": normal(ks[1], lead, (cfg.ssm_conv, c), 0.2, dtype, device),
        "conv_b": const(c, 0.0, dtype),
        "a_log": a_log,
        "dt_bias": const(nh, 0.0, torch.float32),
        "d_skip": const(nh, 1.0, torch.float32),
        "norm_scale": const(di, 1.0, dtype),
        "out_proj": normal(ks[3], lead, (di, d), di ** -0.5, dtype, device),
    }


def _split_in_proj(zxbcdt: torch.Tensor, cfg):
    di, ns, nh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * ns]
    dt = zxbcdt[..., di + di + 2 * ns:]
    if dt.shape[-1] != nh:
        raise ValueError(f"in_proj gives {dt.shape[-1]} dt columns, want {nh}")
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time. xbc: (B,S,C); w: (K,C)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s, :] * w[i] for i in range(k))
    return F.silu(out + b)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Core SSD scan.

    x:  (B, S, H, P)   inputs per head
    dt: (B, S, H)      softplus'd timestep
    a_log: (H,)        -A = exp(a_log)
    b_mat, c_mat: (B, S, N)  input/output projections (single group)
    Returns (y (B,S,H,P) in x's dtype, final_state (B,H,P,N) f32).
    S must be a multiple of Q = min(chunk, S), as the reference asserts.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"SSD chunk {q}")
    nc = s // q

    da = dt * (-torch.exp(a_log))[None, None, :]           # (B,S,H) log-decay
    xr = x.reshape(bsz, nc, q, h, p).to(torch.float32)
    dtr = dt.reshape(bsz, nc, q, h)
    dar = da.reshape(bsz, nc, q, h)
    br = b_mat.reshape(bsz, nc, q, n)
    cr = c_mat.reshape(bsz, nc, q, n)

    cum = torch.cumsum(dar, 2)                              # (B,nc,Q,H)
    seg_total = cum[:, :, -1]                               # (B,nc,H)

    # ----- intra-chunk (attention-like, strictly causal + diagonal) -------
    # L[i,j] = exp(cum_i - cum_j) for i >= j, masked BEFORE the exp
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]    # (B,nc,Q,Q,H)
    tril = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    diff = torch.where(tril[None, None, :, :, None], diff,
                       diff.new_full((), NEG_MASK))
    l_mat = torch.exp(diff)
    del diff
    cb = torch.einsum("bcin,bcjn->bcij", cr, br)            # (B,nc,Q,Q)
    w_ij = cb[..., None] * l_mat * dtr[:, :, None, :, :]    # (B,nc,Q,Q,H)
    del l_mat
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", w_ij, xr)
    del w_ij

    # ----- chunk states ----------------------------------------------------
    decay_to_end = torch.exp(seg_total[:, :, None, :] - cum)  # (B,nc,Q,H)
    state_contrib = torch.einsum("bcqh,bcqn,bcqhp->bchpn",
                                 dtr * decay_to_end, br, xr)

    # ----- the cross-chunk recurrence: the state entering each chunk -------
    h_prev = torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
    decay = torch.exp(seg_total)                            # (B,nc,H)
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h_prev)
        h_prev = h_prev * decay[:, c, :, None, None] + state_contrib[:, c]
    h_prevs = torch.stack(h_prevs, 1)                       # (B,nc,H,P,N)

    # ----- inter-chunk contribution ---------------------------------------
    y_inter = torch.einsum("bcqn,bchpn->bcqhp", cr, h_prevs) \
        * torch.exp(cum)[..., None]
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y.to(x.dtype), h_prev


def ssd_step(x: torch.Tensor, dt: torch.Tensor, a_log: torch.Tensor,
             b_vec: torch.Tensor, c_vec: torch.Tensor, state: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence (decode).

    x: (B,H,P); dt: (B,H); b_vec,c_vec: (B,N); state: (B,H,P,N) f32.
    h' = exp(dt*A) h + dt * x (outer) B;   y = h' C
    """
    da = torch.exp(dt * (-torch.exp(a_log))[None, :])      # (B,H)
    upd = torch.einsum("bh,bhp,bn->bhpn", dt, x.to(torch.float32), b_vec)
    h_new = state * da[:, :, None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", h_new, c_vec)
    return y.to(x.dtype), h_new


def local_ssm_heads(cfg, model: int) -> int:
    """H / P: the SSD heads each of ``model`` = P ranks runs."""
    nh = cfg.ssm_heads
    if model < 1 or nh % model:
        raise ValueError(f"a model axis of {model} must divide ssm_heads="
                         f"{nh}: each rank runs whole SSD heads")
    return nh // model


def conv_channels(cfg, mesh) -> int:
    """The conv cache's channels a rank holds (``sharding_rules.
    cache_specs``): C / P when P divides C = d_inner + 2 ns, else C."""
    c, p = cfg.d_inner + 2 * cfg.ssm_state, parallel.model_size(mesh)
    return c // p if c % p == 0 else c


def conv_block(t: torch.Tensor, width: int, mesh) -> torch.Tensor:
    """This rank's ``width`` channels of ``t`` (..., C): its block in rank
    order, or all of them when ``width`` is C."""
    if width == t.shape[-1]:
        return t
    lo = mesh.model_rank * width
    return t[..., lo:lo + width]


def _heads(p: dict, cfg, mesh) -> tuple[dict, slice, slice]:
    """``p`` with this rank's entries of the per-head and per-channel
    leaves held whole (:data:`SPLIT_USE`; the conv's x channels and every
    B and C channel), and the slices of its heads and of its x channels;
    ``p`` itself and whole slices at P = 1."""
    n = parallel.model_size(mesh)
    if n == 1:
        return p, slice(None), slice(None)
    hl = local_ssm_heads(cfg, n)
    di, r = cfg.d_inner, mesh.model_rank
    heads = slice(r * hl, (r + 1) * hl)
    xs = slice(r * hl * cfg.ssm_head_dim, (r + 1) * hl * cfg.ssm_head_dim)
    out = dict(p)
    for k in ("a_log", "dt_bias", "d_skip"):
        out[k] = p[k][heads]
    out["norm_scale"] = p["norm_scale"][xs]
    for k in ("conv_w", "conv_b"):
        out[k] = torch.cat([p[k][..., xs], p[k][..., di:]], -1)
    return out, heads, xs


def _in_proj(x: torch.Tensor, p: dict, mesh) -> torch.Tensor:
    """``x @ in_proj`` whole on every rank: under a model axis each rank's
    column block, gathered (``x``'s gradient summed over the ranks)."""
    return parallel.gather_columns(
        mesh, parallel.copy_to_model(mesh, x) @ p["in_proj"])


def _gate_out(y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
              p: dict, mesh=None) -> torch.Tensor:
    """D skip (in y's dtype), the gated RMSNorm and the out projection;
    y, xh: (..., H, P); z: (..., d_inner).  Under a model axis this rank's
    heads and d_inner / P channels, the norm's squares and the
    projection's partial outputs summed over the ranks."""
    skip = p["d_skip"][:, None].to(y.dtype)
    y = (y + xh.to(y.dtype) * skip).reshape(z.shape)
    return parallel.reduce_from_model(mesh, (rmsnorm(
        y, p["norm_scale"], mesh=mesh) * F.silu(z)) @ p["out_proj"])


def ssm_block(x: torch.Tensor, p: dict, cfg, mesh=None
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full mamba2 block over a sequence. x: (B,S,D) -> (y, final_state,
    conv tail (B, K-1, C): the last K-1 pre-conv inputs, the decode
    cache's ``conv``).  Under a model axis (``mesh``) the state is this
    rank's heads' (B, H/P, P, N) and the tail whole (module docstring)."""
    di, ns = cfg.d_inner, cfg.ssm_state
    zxbcdt = _in_proj(x, p, mesh)
    z, xbc, dt = _split_in_proj(zxbcdt, cfg)
    conv_tail = xbc[:, -(cfg.ssm_conv - 1):, :]
    p, heads, xs = _heads(p, cfg, mesh)
    if parallel.model_size(mesh) > 1:
        z, dt = z[..., xs], dt[..., heads]
        xbc = torch.cat([xbc[..., xs], xbc[..., di:]], -1)
        di = z.shape[-1]
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    b_mat = xbc[..., di:di + ns].to(torch.float32)
    c_mat = xbc[..., di + ns:].to(torch.float32)
    dt = softplus(dt.to(torch.float32) + p["dt_bias"])
    bsz, s, _ = x.shape
    xh = xbc[..., :di].reshape(bsz, s, -1, cfg.ssm_head_dim)
    y, h_final = ssd_chunked(xh, dt, p["a_log"], b_mat, c_mat, cfg.ssm_chunk)
    return _gate_out(y, xh, z, p, mesh), h_final, conv_tail


def ssm_block_step(x: torch.Tensor, p: dict, cfg, conv_tail: torch.Tensor,
                   state: torch.Tensor, mesh=None
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode token. x: (B,1,D); conv_tail: (B,K-1,C); state
    (B,H,P,N) -> (y (B,1,D), new tail, new state).  Under a model axis
    (``mesh``) the tail is this rank's block of C / P channels
    (:func:`conv_channels`; whole when P does not divide C) and the state
    its heads': the rank convolves its block, the blocks' outputs are
    gathered, and it takes its heads' x and the whole B and C."""
    di, ns = cfg.d_inner, cfg.ssm_state
    zxbcdt = _in_proj(x, p, mesh)
    z, xbc, dt = _split_in_proj(zxbcdt, cfg)
    width = conv_tail.shape[-1]
    hist = torch.cat([conv_tail, conv_block(xbc, width, mesh)], 1)  # (B,K,c)
    kk = p["conv_w"].shape[0]
    w, b = (conv_block(p[k], width, mesh) for k in ("conv_w", "conv_b"))
    conv_out = sum(hist[:, i] * w[i] for i in range(kk))
    xbc1 = F.silu(conv_out + b)                            # (B,c)
    if width != xbc.shape[-1]:
        xbc1 = parallel.gather_columns(mesh, xbc1)         # (B,C)
    p, heads, xs = _heads(p, cfg, mesh)
    x_loc = xbc1[..., :di][..., xs]
    b_vec = xbc1[..., di:di + ns].to(torch.float32)
    c_vec = xbc1[..., di + ns:].to(torch.float32)
    dt1 = softplus(dt[:, 0, heads].to(torch.float32) + p["dt_bias"])
    xh = x_loc.reshape(x.shape[0], -1, cfg.ssm_head_dim)
    y, state_new = ssd_step(xh, dt1, p["a_log"], b_vec, c_vec, state)
    return (_gate_out(y, xh, z[:, 0, xs], p, mesh)[:, None], hist[:, 1:],
            state_new)
