"""Activation-sharding hint context, port of ``repro.distributed.ctx``.

Model code calls ``constrain(x, "dp", None, ..., "tp")`` with LOGICAL axis
names; a step builder installs the active rules with
:func:`activation_rules`.  Outside a rules context (unit tests,
single-device runs) :func:`constrain` returns ``x`` itself.

The reference's ``with_sharding_constraint`` pins GSPMD's layout
propagation.  Here a layout is a DTensor's placements: inside a rules
context a DTensor is redistributed to the rules' placements over its own
mesh (:func:`~repro_torch.distributed.sharding.redistribute`, staged
through the host on a ``gloo`` world of card tensors), and a plain tensor,
which has no layout to pin, is returned unchanged.  The step builders of
:mod:`repro_torch.launch.steps` install the rules around each model call;
they hand the model local tensors, laid out by the builder itself, so the
reference's ``constrain`` hints would be the identity there and the port's
models leave them out.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch

from repro_torch.distributed.sharding import (ShardingRules, logical_to_physical, placements,
                                              redistribute)

_RULES: contextvars.ContextVar[Optional[ShardingRules]] = \
    contextvars.ContextVar("sharding_rules", default=None)

__all__ = ["activation_rules", "constrain"]


@contextlib.contextmanager
def activation_rules(rules: Optional[ShardingRules]):
    """Install ``rules`` (``None``: none) for :func:`constrain` within the
    block."""
    tok = _RULES.set(rules)
    try:
        yield
    finally:
        _RULES.reset(tok)


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """``x`` laid out as the logical spec says under the active rules."""
    rules = _RULES.get()
    if rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    return redistribute(x, placements(logical_to_physical(logical, rules), x.device_mesh))
