"""Model registry, port of ``repro.models.registry`` for the family the port
runs: ``dit``, the paper's own.  The LM families (``dense``, ``moe``,
``ssm``, ``hybrid``, ``encdec``, ``vlm``) and their prefill and decode entry
points are not ported yet (ROADMAP A.10); ``param_specs`` is a GSPMD
sharding spec and has no counterpart here."""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import dit

__all__ = ["get_model", "Model"]


class Model:
    """The reference's adapter: ``init_params`` and ``train_loss(params, batch)``."""

    def __init__(self, cfg: ArchConfig):
        if cfg.family != "dit":
            raise NotImplementedError(
                f"model family {cfg.family!r} is not ported yet (ROADMAP A.10); "
                "the port runs 'dit'")
        self.cfg = cfg
        self.mod = dit

    def init_params(self, generator: torch.Generator, device) -> dict:
        return self.mod.init_params(self.cfg, generator, device)

    def train_loss(self, params: dict, batch: dict, *,
                   dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return self.mod.train_loss(params, self.cfg, batch, dtype=dtype)


def get_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
