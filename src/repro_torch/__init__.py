"""PyTorch/CUDA port of the MPK reproduction.

``repro_torch`` serves the decode loop of the dense models through a
persistent megakernel written by hand in CUDA C++ for Hopper
(``megakernel/csrc/megakernel.cu``), beside a plain PyTorch model that
runs prefill and serves as the decode oracle.  It imports ``torch`` and
never ``jax``; the compiler passes (``core``), configs and the serving
engine are its own copies of the framework-neutral modules of the JAX
package ``repro``, which stays the reference.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.

    from repro_torch.api import compile
    prog = compile(cfg, batch=2, max_seq=128, backend="megakernel")
"""
