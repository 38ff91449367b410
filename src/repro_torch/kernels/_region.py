"""Named regions around the kernel wrappers.

A CUDA kernel launches through ``ctypes``, which PyTorch's dispatcher never
sees, so an op recorder (:mod:`repro_torch.analysis.op_walk`) cannot see a
kernel as an op.  Each wrapper is therefore decorated with
:func:`kernel_region`: while a listener is installed, the wrapper's call is
reported as one named region with its bound arguments and its result, and
every op it runs inside (on the card the output clone, on the CPU the whole
plain version) lies within that region.  With no listener the decorator
costs one list check.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Iterator

__all__ = ["kernel_region", "listening"]

_LISTENERS: list = []


def kernel_region(fn):
    """Report each call of the kernel wrapper ``fn`` as a region named after it."""
    sig = inspect.signature(fn)

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        if not _LISTENERS:
            return fn(*args, **kw)
        bound = sig.bind(*args, **kw).arguments
        listeners = tuple(_LISTENERS)
        for lis in listeners:
            lis.enter_region(fn.__name__, bound)
        out = None
        try:
            out = fn(*args, **kw)
            return out
        finally:
            for lis in reversed(listeners):
                lis.exit_region(fn.__name__, out)

    return wrapper


@contextlib.contextmanager
def listening(listener) -> Iterator[None]:
    """Install ``listener`` (``enter_region(name, bound_args)``,
    ``exit_region(name, result)``) for the block."""
    _LISTENERS.append(listener)
    try:
        yield
    finally:
        _LISTENERS.remove(listener)
