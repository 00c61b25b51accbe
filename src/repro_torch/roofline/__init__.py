from .hw import HW, TPU_V5E

__all__ = ["HW", "TPU_V5E"]
