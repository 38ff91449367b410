"""FlashOmni on PyTorch and CUDA (NVIDIA Hopper, sm_90a).

A port of the JAX package ``repro`` that mirrors its layout (``configs``,
``core``, ``kernels``, ``models``, ``diffusion``, ``launch``).  Plain tensor
code is PyTorch; the three Dispatch kernels of the serving path (GEMM-Q,
CSR sparse attention, GEMM-O) are hand-written CUDA C++ under ``csrc/``,
built with ``nvcc`` at first use.  The package imports neither ``jax`` nor
``repro``: ``repro`` is the reference the port's tests hold it against.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; on a CPU tensor each kernel wrapper runs its plain PyTorch
version instead.
"""
