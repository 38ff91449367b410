"""Parameter conversion from the JAX package's pytrees.

``repro.models.dit.init_params`` draws its weights from ``jax.random``,
which PyTorch cannot reproduce.  A test moves that pytree across as numpy
arrays (``jax.tree.map(np.asarray, params)``) and this module turns it into
the port's parameter dict: the same nesting, stacked ``(L, ...)`` block
leaves, every leaf a tensor.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_jax"]


def params_from_jax(tree, device="cpu"):
    """Nested dicts/lists of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)
