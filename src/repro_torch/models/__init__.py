"""Model zoo of the port (dense family)."""
from .model import Model, ModelConfig, build_model, param_count

__all__ = ["Model", "ModelConfig", "build_model", "param_count"]
