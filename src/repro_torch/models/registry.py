"""Model registry, port of ``repro.models.registry``: every family of the
reference, ``dit`` (the paper's own), the decoder-only LMs ``dense`` and
``moe`` (``models/transformer``), ``ssm`` (``models/ssm``), ``hybrid``
(``models/rglru``), ``encdec`` (``models/encdec``) and ``vlm``
(``models/vision``).  ``param_specs`` and ``cache_specs`` return the
family's logical sharding specs (:mod:`repro_torch.launch.steps` lays the
state out by them)."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import dit, encdec, rglru, ssm, transformer, vision
from repro_torch.tree import tree_leaves

__all__ = ["get_model", "Model", "param_count", "LM_FAMILIES"]

_FAMILIES = {"dense": transformer, "moe": transformer, "vlm": vision, "ssm": ssm,
             "hybrid": rglru, "encdec": encdec, "dit": dit}
# The families that decode tokens (every one but dit): launch/serve.serve_lm.
LM_FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# The LM families whose prefill takes the tokens alone; encdec and vlm take
# the batch dict (with ``frames`` or ``patches``).
_TOKEN_FAMILIES = ("dense", "moe", "ssm", "hybrid")


class Model:
    """The reference's adapter: ``init_params``, ``param_specs``,
    ``train_loss(params, batch)``, ``prefill(params, batch)``, ``init_cache``,
    ``cache_specs`` and
    ``decode_step(params, cache, token, pos)``; and ``forward(params,
    batch)`` for the LM families."""

    def __init__(self, cfg: ArchConfig):
        if cfg.family not in _FAMILIES:
            raise KeyError(f"unknown model family {cfg.family!r}; known: {sorted(_FAMILIES)}")
        self.cfg = cfg
        self.mod = _FAMILIES[cfg.family]

    def init_params(self, generator, device) -> dict:
        return self.mod.init_params(self.cfg, generator, device)

    def param_specs(self) -> dict:
        return self.mod.param_specs(self.cfg)

    def block_groups(self) -> tuple:
        """The top-level groups of stacked blocks (``layers.block`` takes
        them one block at a time)."""
        return self.mod.BLOCK_GROUPS

    def train_loss(self, params: dict, batch: dict, *,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return self.mod.train_loss(params, self.cfg, batch, dtype=dtype)

    def _inputs(self, batch: dict):
        return batch["tokens"] if self.cfg.family in _TOKEN_FAMILIES else batch

    def forward(self, params: dict, batch: dict, *, dtype: torch.dtype = torch.bfloat16):
        """``(logits, aux)`` of the family's ``forward`` on ``batch`` (an LM
        family's; the reference's adapter has no such entry)."""
        return self.mod.forward(params, self.cfg, self._inputs(batch), dtype=dtype)

    def prefill(self, params: dict, batch: dict, *, dtype: torch.dtype = torch.bfloat16):
        return self.mod.prefill(params, self.cfg, self._inputs(batch), dtype=dtype)

    def init_cache(self, batch_size: int, max_len: int, dtype: torch.dtype = torch.bfloat16,
                   *, device) -> dict:
        return self.mod.init_cache(self.cfg, batch_size, max_len, dtype, device=device)

    def cache_specs(self) -> dict:
        return self.mod.cache_specs(self.cfg)

    def decode_step(self, params: dict, cache: dict, token: torch.Tensor, pos, *,
                    dtype: torch.dtype = torch.bfloat16):
        return self.mod.decode_step(params, self.cfg, cache, token, pos, dtype=dtype)


def get_model(cfg: ArchConfig) -> Model:
    return Model(cfg)


def param_count(cfg: ArchConfig) -> int:
    """Parameters of ``cfg``'s model, reckoned from the shapes its
    ``init_params`` builds on the ``meta`` device (nothing is allocated).
    ``ArchConfig.n_params`` is the reference's approximate formula."""
    return sum(t.numel() for t in tree_leaves(get_model(cfg).init_params(None, "meta")))
