"""Error-feedback state for LGC (paper Algorithm 1, lines 8-11).

Port of ``repro/core/error_feedback.py:54-90``.  At a sync of device m:

    u_m  = e_m + w_m - w_hat_m^{t+1/2}          (net progress + carried error)
    g_m  = LGC_k(u_m)                           (compressed update, uploaded)
    e_m' = u_m - g_m                            (error kept for next round)

Between syncs e_m is untouched.  ``u == g + e'`` holds exactly, since g is
a masked copy of u.

The population-scale EF stores (reference :93-195) hold the residuals of
all N devices of a :class:`~.population.Population` on its device (the
card by default) behind one ``gather(ids)`` / ``scatter(ids, ef)``
contract: "dense" (N, D) f32, "int8" codes with one f32 scale per device,
"server" one shared (D,) residual.  ``gather`` is ``index_select`` and
``scatter`` ``index_copy_``, enqueued with no host sync.  They compute
what the reference's numpy computes, bit for bit: numpy keeps subnormals,
so the stores never flush (the window flushes where XLA:CPU does).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.device import upload
from repro_torch.kernels.ref import div_f32, ftz_add

from .compressor import LGCCompressor


class EFState(NamedTuple):
    """Flat error memory, one vector per FL device."""
    e: torch.Tensor  # (D,) float32


def init_ef(d: int, device: str | torch.device = "cpu") -> EFState:
    return EFState(e=torch.zeros((d,), dtype=torch.float32, device=device))


def ef_compress(state: EFState, delta: torch.Tensor,
                compressor: LGCCompressor,
                received: Sequence[bool] | None = None
                ) -> tuple[torch.Tensor, EFState]:
    """One error-compensated compression step: returns (g, new state).

    ``received[c]`` False drops layer c on its channel; its mass stays in
    the error memory (e' = u - g_sent), to be sent again later."""
    u = ftz_add(state.e, delta)        # flushed, as the reference adds
    g_sent = compressor(u, received)
    return g_sent, EFState(e=u - g_sent)


# ---------------------------------------------------------------------------
# population-scale EF stores (cohort gather / scatter)
# ---------------------------------------------------------------------------

def ids_on(ids, device: torch.device) -> torch.Tensor:
    """Global device ids (numpy or a tensor) as an int64 tensor on
    ``device``, uploaded without waiting."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.from_numpy(np.asarray(ids, np.int64))
    return upload(ids.to(torch.int64), device)


class DenseEFStore:
    """(N, D) f32 residuals: the lossless store, 4 N D bytes (3.14 GB for
    N = 100,000 at lr_mnist's D = 7,850)."""

    name = "dense"

    def __init__(self, n: int, d: int, device: str | torch.device = "cpu"):
        self.n, self.d, self.device = n, d, torch.device(device)
        self._e = torch.zeros((n, d), dtype=torch.float32,
                              device=self.device)

    @property
    def nbytes(self) -> int:
        return self._e.numel() * self._e.element_size()

    def gather(self, ids) -> torch.Tensor:
        """(M, D) f32 residuals of the cohort ``ids``."""
        return self._e.index_select(0, ids_on(ids, self.device))

    def scatter(self, ids, ef: torch.Tensor) -> None:
        """Write the cohort's residuals back."""
        self._e.index_copy_(0, ids_on(ids, self.device),
                            ef.to(self.device, torch.float32))


class Int8EFStore:
    """int8 residual codes and one f32 scale per device, N (D + 4) bytes.

    ``scale = max|e| / 127``, ``code = rint(e / scale)`` (half to even);
    decode ``code * scale``; an all-zero row keeps scale 0 and decodes to
    zeros.  The divisions are true divisions on the card too
    (``kernels.ref.div_f32``), and a code goes through int32 to int8, so an
    out-of-range quotient (possible only for a row whose maximum is deep in
    the subnormals) wraps as numpy's cast wraps, on the CPU and the card
    alike."""

    name = "int8"

    def __init__(self, n: int, d: int, device: str | torch.device = "cpu"):
        self.n, self.d, self.device = n, d, torch.device(device)
        self._codes = torch.zeros((n, d), dtype=torch.int8,
                                  device=self.device)
        self._scale = torch.zeros((n,), dtype=torch.float32,
                                  device=self.device)

    @property
    def nbytes(self) -> int:
        return self._codes.numel() + 4 * self._scale.numel()

    def gather(self, ids) -> torch.Tensor:
        ids = ids_on(ids, self.device)
        return (self._codes.index_select(0, ids).to(torch.float32)
                * self._scale.index_select(0, ids)[:, None])

    def scatter(self, ids, ef: torch.Tensor) -> None:
        ids = ids_on(ids, self.device)
        ef = ef.to(self.device, torch.float32)
        scale = div_f32(ef.abs().amax(1), 127.0)
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        codes = torch.round(ef / safe[:, None]).to(torch.int32)
        self._codes.index_copy_(0, ids, codes.to(torch.int8))
        self._scale.index_copy_(0, ids, scale)


class ServerEFStore:
    """One shared (D,) residual at the server; devices keep none.

    ``gather`` gives every cohort row the shared residual, the window
    computes e_m' = u_m - g_m per row, and ``scatter`` keeps the cohort
    mean: numpy's ``mean(axis=0)``, the rows added in turn to a zero (so a
    column of -0.0 gives +0.0) and then divided by M.  4 D bytes for any
    N."""

    name = "server"

    def __init__(self, n: int, d: int, device: str | torch.device = "cpu"):
        self.n, self.d, self.device = n, d, torch.device(device)
        self._e = torch.zeros((d,), dtype=torch.float32, device=self.device)

    @property
    def nbytes(self) -> int:
        return 4 * self._e.numel()

    def gather(self, ids) -> torch.Tensor:
        return self._e.expand(len(ids), self.d).clone()

    def scatter(self, ids, ef: torch.Tensor) -> None:
        ef = ef.to(self.device, torch.float32)
        total = torch.zeros_like(self._e)
        for row in ef:
            total = total + row
        self._e = div_f32(total, ef.shape[0])


EF_STORES: dict[str, type] = {
    "dense": DenseEFStore,
    "int8": Int8EFStore,
    "server": ServerEFStore,
}


def make_ef_store(kind: str, n: int, d: int,
                  device: str | torch.device = "cpu"):
    """A registered EF store ("dense" | "int8" | "server") on ``device``."""
    try:
        cls = EF_STORES[kind]
    except KeyError:
        raise ValueError(f"unknown EF store {kind!r}; registered: "
                         f"{sorted(EF_STORES)}") from None
    return cls(n, d, device)
