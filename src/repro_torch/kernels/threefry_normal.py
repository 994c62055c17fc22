"""The weights' draw: a CUDA kernel (csrc/threefry_normal.cu).

The reference draws each weight as ``(jax.random.normal(key, shape) *
std).astype(dtype)`` (``repro/models/layers.py:257-277``), which the port
reproduces bit for bit with torch ops (:func:`repro_torch.core.prng.normal`,
a few hundred elementwise passes).  :func:`threefry_normal` fills a tensor
with the same bits in one launch: threefry2x32, XLA:CPU's ``erf_inv``, the
scale and the cast per element in registers.  It is not the port of a TPU
kernel; it keeps a full-width model's start-up to seconds.

For a CPU tensor the wrapper calls the plain version
(:func:`repro_torch.kernels.ref.threefry_normal_ref`); for a CUDA tensor it
launches the kernel or raises.  The two are bitwise equal (chip_smoke.py on
the card).
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, ref
from .topk_threshold import _on_device, _sm_count, _stream

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_THREADS = 256                 # threads per block (lgc::kThreads)
_BLOCKS_PER_SM = 32            # grid-stride blocks a SM: a short last wave


def threefry_normal(out: torch.Tensor, key: torch.Tensor, std: float
                    ) -> torch.Tensor:
    """``out <- (normal(key, out.shape) * std).to(out.dtype)`` in place.

    Args:
      out: contiguous f32 or bf16 tensor of any shape.
      key: a (2,) key (:func:`repro_torch.core.prng.PRNGKey`), on any device.
      std: the scale, rounded to f32 as torch rounds a Python scalar.

    Returns ``out``.
    """
    if out.dtype not in _DTYPE_CODE:
        raise TypeError(f"out must be float32 or bfloat16, got {out.dtype}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    if tuple(key.shape) != (2,):
        raise ValueError(f"key must have shape (2,), got {tuple(key.shape)}")
    if out.device.type == "cpu":
        return out.copy_(ref.threefry_normal_ref(key, out.shape, std,
                                                 out.dtype, out.device))
    n = out.numel()
    if n == 0:
        return out
    k0, k1 = (int(v) for v in key.tolist())
    blocks = min(-(-n // _THREADS), _BLOCKS_PER_SM * _sm_count(out.device))
    with _on_device(out):
        err = _build.lib().lgc_threefry_normal(
            k0, k1, ctypes.c_float(std), out.data_ptr(), n,
            _DTYPE_CODE[out.dtype], blocks, _stream(out))
    _build.check(err, "threefry_normal")
    return out
