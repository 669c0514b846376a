"""Batched serving: the decode engine (port of ``repro/serve``)."""
from .engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
