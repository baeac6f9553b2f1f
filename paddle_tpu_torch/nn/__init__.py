"""Layers and the attention dispatch of the port's models."""
