"""FlashOmni on PyTorch and CUDA (NVIDIA Hopper, sm_90a).

A port of the JAX package ``repro`` that mirrors its layout (``configs``,
``core``, ``kernels``, ``models``, ``diffusion``, ``launch``).  Plain tensor
code is PyTorch; the seven kernels of the reference (GEMM-Q, CSR sparse
attention, GEMM-O, their occupancy-bucketed attention and GEMM-O, the
attention on the packed symbols and the TaylorSeer reuse) are hand-written
CUDA C++ under ``csrc/``, built with ``nvcc`` at first use and reached
through :mod:`repro_torch.kernels.ops`.  ``python -m repro_torch.quickstart``
drives one layer through them.  The package imports neither ``jax`` nor
``repro``: ``repro`` is the reference the port's tests hold it against.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU; on a CPU tensor each kernel wrapper runs its plain PyTorch
version instead.
"""
