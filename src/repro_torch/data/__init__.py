"""Data streams of the port."""
from .pipeline import SyntheticLM

__all__ = ["SyntheticLM"]
