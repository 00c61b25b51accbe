"""The port's Program API (``compile`` → ``Program``)."""
from .program import (BACKENDS, MegakernelProgram, Program, TorchProgram,
                      compile)

__all__ = ["BACKENDS", "MegakernelProgram", "Program", "TorchProgram",
           "compile"]
