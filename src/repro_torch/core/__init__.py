"""Simulator core of the port (only the compressor constants so far)."""
from .compressor import PALLAS_MIN_ELEMS

__all__ = ["PALLAS_MIN_ELEMS"]
