"""Checkpointing (``repro/checkpoint``): a msgpack manifest (the port's own
codec, :mod:`.msgpack`) and one .npy blob per leaf."""
from .io import latest_step, load_checkpoint, restore, save_checkpoint

__all__ = ["latest_step", "load_checkpoint", "restore", "save_checkpoint"]
