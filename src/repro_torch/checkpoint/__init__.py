"""Checkpoint directories (the plan database's storage)."""

from .checkpointer import Checkpointer

__all__ = ["Checkpointer"]
