"""Data pipelines of the port (numpy only, copied from the reference)."""
from .tokens import TokenPipeline

__all__ = ["TokenPipeline"]
