"""Compression constants of the port.

Only the kernel routing floor is ported so far (``repro/core/compressor.py``
:222); the rank-exact compressors, QSGD and the per-layer budgets wait for
the simulator slice (ROADMAP A2, A8).
"""

#: flat leaves at least this large take the CUDA kernels when the backend is
#: ``"cuda"``; smaller leaves take the plain torch path
PALLAS_MIN_ELEMS = 100_000
