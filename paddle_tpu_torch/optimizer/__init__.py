"""Optimizers of the port."""
from .optimizer import AdamW

__all__ = ["AdamW"]
