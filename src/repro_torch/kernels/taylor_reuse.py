"""OP_reuse — the TaylorSeer forecast over the cached blocks only (paper §3.4,
cache-then-reuse).

Port of ``repro.kernels.taylor_reuse.taylor_reuse_kernel``.  The CUDA kernel
is ``csrc/taylor_reuse.cu`` (its header says what bounds it on the H100 and
how the design answers that); the plain version is
:func:`repro_torch.kernels.ref.taylor_reuse_blocks_ref`.  A CPU tensor runs
the plain version; a CUDA tensor launches the kernel or raises; a ``meta``
tensor (the dry run's) passes the CUDA route's checks and returns an empty
``meta`` output, launching and counting nothing.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._region import kernel_region
from repro_torch.kernels.ref import taylor_reuse_blocks_ref

__all__ = ["taylor_reuse_kernel"]


@kernel_region
def taylor_reuse_kernel(derivs: torch.Tensor, coef: torch.Tensor, base: torch.Tensor,
                        ids: torch.Tensor, cnt: torch.Tensor, *, block: int) -> torch.Tensor:
    """``out[bh, block ids[bh,c]] = Σ_d coef[d]·derivs[d, bh, block]`` for
    ``c < cnt[bh]``; every other block keeps ``base``.

    derivs (D+1, BH, N, d) and base (BH, N, d), float32 or bfloat16 each;
    coef D+1 float32 values (any shape); ids (BH, Cc) and cnt (BH,) int32;
    ``block`` divides N.  The sum runs in f32 and is stored in base's dtype.
    ``base`` is cloned once into the output, which the kernel then updates in
    place.  ``taylor_reuse_kernel.launches`` counts the CUDA launches.
    """
    if base.device.type == "cpu":
        return taylor_reuse_blocks_ref(derivs, coef, base, ids, cnt, block=block)
    lib = None if base.is_meta else _build.load()
    o1, bh, n, d = derivs.shape
    cc = ids.shape[-1]
    if n % block:
        raise ValueError(f"block {block} does not divide N {n}")
    if coef.numel() != o1:
        raise ValueError(f"coef has {coef.numel()} values for a stack of {o1} orders")
    dev = base.device
    coef = coef.reshape(o1)
    _build.check("derivs", derivs, dev, derivs.dtype, (o1, bh, n, d))
    _build.check("coef", coef, dev, torch.float32, (o1,))
    _build.check("base", base, dev, base.dtype, (bh, n, d))
    _build.check("ids", ids, dev, torch.int32, (bh, cc))
    _build.check("cnt", cnt, dev, torch.int32, (bh,))
    out = base.clone()
    if lib is None:                     # meta: shapes only, nothing to launch
        return out
    rc = lib.fo_taylor_reuse(_build.dtype_code(derivs.dtype), _build.dtype_code(base.dtype),
                             derivs.data_ptr(), coef.data_ptr(), out.data_ptr(), ids.data_ptr(),
                             cnt.data_ptr(), o1, bh, n, d, cc, block, _build.stream_of(dev))
    _build.raise_on_error(lib, rc, "taylor_reuse_kernel")
    taylor_reuse_kernel.launches += 1
    return out


taylor_reuse_kernel.launches = 0
