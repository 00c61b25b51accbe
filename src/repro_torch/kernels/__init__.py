"""Standalone kernels of the port: ``matmul``, ``rmsnorm`` and
``flash_attention``, the counterparts of the JAX package's
``repro.kernels`` (the megakernel lives in ``repro_torch.megakernel``).

Each is written by hand in CUDA C++ for Hopper (``csrc/standalone.cu``,
built with ``nvcc`` at the first launch, never at import) and keeps the
reference's name and keywords, less ``interpret``.  Tensors on the card
launch the kernel; tensors on the CPU run its plain PyTorch version
(``*_plain``, the reference kernel's algorithm in torch ops); any other
device raises.  ``ref`` holds the plain-torch oracles of the reference's
``repro/kernels/ref.py``; ``launch_counts`` counts each kernel's launches.
"""
from .build import launch_counts, reset_launch_counts
from .flash_attention import flash_attention, flash_attention_plain
from .matmul import matmul, matmul_plain
from .rmsnorm import rmsnorm, rmsnorm_plain

__all__ = ["flash_attention", "matmul", "rmsnorm", "flash_attention_plain",
           "matmul_plain", "rmsnorm_plain", "launch_counts",
           "reset_launch_counts"]
