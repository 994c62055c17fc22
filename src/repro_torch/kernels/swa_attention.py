"""Sliding-window flash decode attention: a CUDA kernel.

Port of ``repro/kernels/swa_attention.py:23-85``.  One new query token per
(batch row, query head) attends to a window KV cache of W slots, of which
the first ``length[b]`` are valid.  The cache keeps its Kv heads: query head
h reads KV head ``h // (H // Kv)``, so a GQA cache is never expanded.  The
kernel (csrc/swa_decode.cu) computes the Pallas kernel's function -- f32
logits scaled by 1/sqrt(Dh), an online softmax with an f32 accumulator, the
output in q's dtype.  A block serves a group of up to 8 (``_MAX_REP``) of a
KV head's query heads, and each group reads the head's valid K/V rows
once: once in all at REP <= 8, twice at REP 9 to 16 (starcoder2-7b's 9,
glm4-9b's 16), since both groups stream the same rows.  Slots at or past
``length`` are never read.  W is any size >= 1: a cache without a window
has ``prompt + gen`` slots.  One launch splits W over the card's SMs
(:func:`_num_splits`) and merges the splits in order, as
:func:`repro_torch.kernels.ref.swa_decode_split_ref` does.

:func:`swa_decode_partial` is the same launch returning the f32 output
with the row's softmax state (m, l), for decode attention over one rank's
shard of a cache's slots (serving under the model axis).

For a CPU tensor each wrapper calls its plain version
(:func:`repro_torch.kernels.ref.swa_decode_ref`,
:func:`~repro_torch.kernels.ref.swa_decode_partial_ref`); for a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from . import _build, ref
from .topk_threshold import (_check_same_device, _on_device, _sm_count,
                             _stream, _zeroed_counters)

HEAD_DIMS = (32, 64, 96, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_MAX_REP = 8                   # query heads per block (swa_decode.cu kMaxRep)
_MAX_SPLITS = 128              # swa_decode.cu kMaxSplits


def _num_splits(groups: int, w: int, sms: int = 132) -> int:
    """Splits S of a W-slot window for ``groups`` (b, KV head, query-head
    group): about one block per SM (groups x S >= sms before the splits are
    rounded to whole tiles of ``ref.SWA_TILE`` slots, and at least sms / 2
    after), none starting past W, and at most ``_MAX_SPLITS``.  One block
    per SM with longer splits beat two with shorter ones at the serve
    shape: 8 splits of 512 slots against 16 of 256 (PERF.md;
    ``python -m repro_torch.launch.bench_swa_splits`` measures it)."""
    tiles = -(-w // ref.SWA_TILE)
    want = min(tiles, _MAX_SPLITS, -(-sms // groups))
    return -(-tiles // -(-tiles // want))


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  length: torch.Tensor) -> None:
    """Raise for what the kernel does not take."""
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if length.dtype != torch.int32:
        raise TypeError(f"length must be int32, got {length.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"want q (B, H, Dh) and k, v (B, Kv, W, Dh); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, dh = q.shape
    kb, kv, w, kdh = k.shape
    if kb != b or kdh != dh or tuple(length.shape) != (b,):
        raise ValueError(f"shapes disagree: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, length {tuple(length.shape)}")
    if kv < 1 or h % kv:
        raise ValueError(f"H={h} must be a multiple of Kv={kv}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {HEAD_DIMS}")
    if b < 1 or w < 1:
        raise ValueError(f"empty batch or window: B={b}, W={w}")
    for name, t in (("q", q), ("k", k), ("v", v), ("length", length)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    _check_same_device(q, k, v, length)
    if q.device.type == "cpu":
        return
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            length: torch.Tensor, partial: bool):
    """One launch of the plain form (the output in q's dtype) or of the
    partial form ((out f32, m, l))."""
    b, h, dh = q.shape
    kv, w = k.shape[1], k.shape[2]
    groups = b * kv * -(-(h // kv) // _MAX_REP)
    splits = _num_splits(groups, w, _sm_count(q.device))
    part = torch.empty(b * h * splits * (dh + 2), dtype=torch.float32,
                       device=q.device)
    counters = _zeroed_counters("swa_decode", q.device, groups)
    args = (b, h, kv, w, dh, _DTYPE_CODE[q.dtype], splits, _stream(q))
    with _on_device(q):
        if partial:
            out = torch.empty(q.shape, dtype=torch.float32, device=q.device)
            m = torch.empty((b, h), dtype=torch.float32, device=q.device)
            l_sum = torch.empty_like(m)
            err = _build.lib().lgc_swa_decode_partial(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                out.data_ptr(), m.data_ptr(), l_sum.data_ptr(),
                part.data_ptr(), counters.data_ptr(), *args)
        else:
            out = torch.empty_like(q)
            err = _build.lib().lgc_swa_decode(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(),
                out.data_ptr(), part.data_ptr(), counters.data_ptr(), *args)
    name = "swa_decode_partial" if partial else "swa_decode"
    _build.check(err, name)
    return (out, m, l_sum) if partial else out


def swa_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               length: torch.Tensor) -> torch.Tensor:
    """Decode attention of one token over a window cache.

    Args:
      q: (B, H, Dh) new-token queries.
      k, v: (B, Kv, W, Dh) cache, ``H % Kv == 0``.
      length: (B,) int32 valid slots per row (clamped to [0, W]; 0 gives
        zeros).

    Returns (B, H, Dh) in q's dtype.
    """
    _check_inputs(q, k, v, length)
    if q.device.type == "cpu":
        return ref.swa_decode_ref(q, k, v, length)
    return _launch(q, k, v, length, partial=False)


def swa_decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       length: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`swa_decode` with its softmax state, for a shard of a cache's
    slots whose states merge across ranks
    (:func:`repro_torch.kernels.ref.merge_decode_partials`).

    Takes what :func:`swa_decode` takes and returns (out (B, H, Dh) f32,
    m (B, H) f32, l (B, H) f32): out is acc / max(l, 1e-30) before the
    cast to q's dtype (so ``out.to(q.dtype)`` is :func:`swa_decode`'s
    output), m the max of the row's scaled logits and l the sum of
    exp(logit - m); an empty row gives m = -inf, l = 0 and zeros.  One
    launch, the grid and splits of :func:`swa_decode`.
    """
    _check_inputs(q, k, v, length)
    if q.device.type == "cpu":
        return ref.swa_decode_partial_ref(q, k, v, length)
    return _launch(q, k, v, length, partial=True)
