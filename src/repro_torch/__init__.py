"""PyTorch / CUDA port of the LGC system, beside the JAX + Pallas reference
package ``repro``.

The port keeps the reference's module names (``configs``, ``data``,
``kernels``, ``core``, ``models``, ``launch``) so each module has an obvious
counterpart.  It imports ``torch`` and numpy only -- never ``jax`` and
nothing under ``repro`` (tests/test_torch_lgc_step.py::TestGuards pins it).

Entry points run on the card: ``device=None`` means ``"cuda"`` and raises
when CUDA is absent; the CPU path is asked for with ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
