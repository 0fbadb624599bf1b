"""Checkpoints in the JAX package's format (npz leaves + JSON sidecar),
with step rotation and a background writer."""
from .checkpoint import AsyncCheckpointer, latest, restore, save

__all__ = ["AsyncCheckpointer", "latest", "restore", "save"]
