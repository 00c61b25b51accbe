from .base import ModelConfig, ShapeConfig, SHAPES
from .registry import ARCHS, get_config, list_archs

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "ARCHS", "get_config",
           "list_archs"]
