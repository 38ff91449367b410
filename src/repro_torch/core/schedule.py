"""Per-step sparsity schedule, port of ``repro.core.schedule`` (config
mapping only).

A :class:`SparsitySchedule` is a per-step mode array (dense / update /
dispatch) plus a (step × layer) table of ids into its strategy tuple.  The
reference traces both as data through one ``lax.scan``; the port's sampler
is a Python loop, so the schedule stays on the host and the DiT looks each
layer's strategy up by id.  Named presets (``hunyuan-1.5x``, ``step-ramp``)
and per-layer tables are not ported yet.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.strategy import get_strategy

__all__ = ["MODE_DENSE", "MODE_UPDATE", "MODE_DISPATCH", "MODE_NAMES",
           "SparsitySchedule"]

MODE_DENSE, MODE_UPDATE, MODE_DISPATCH = 0, 1, 2
MODE_NAMES = ("dense", "update", "dispatch")


def _mode_array(cfg, num_steps: int) -> np.ndarray:
    """Per-step Update/Dispatch phases from the config's warmup/interval."""
    from repro_torch.core.engine import is_update_step
    return np.asarray([MODE_UPDATE if is_update_step(i, cfg) else MODE_DISPATCH
                       for i in range(num_steps)], np.int32)


@dataclasses.dataclass(frozen=True)
class SparsitySchedule:
    """``mode`` (S,) int32, ``strategy_ids`` (S, L) int32 into ``strategies``."""

    mode: np.ndarray
    strategy_ids: np.ndarray
    strategies: tuple = ()

    @property
    def num_steps(self) -> int:
        return self.mode.shape[0]

    def kinds(self) -> list[str]:
        """Per-step phase names (trace/diagnostics)."""
        return [MODE_NAMES[int(m)] for m in self.mode]

    @classmethod
    def from_config(cls, cfg, num_steps: int, n_layers: int) -> "SparsitySchedule":
        """Every layer runs ``cfg.strategy``; Update/Dispatch follow the
        config's warmup and interval."""
        return cls(mode=_mode_array(cfg, num_steps),
                   strategy_ids=np.zeros((num_steps, n_layers), np.int32),
                   strategies=(get_strategy(cfg.strategy),))
