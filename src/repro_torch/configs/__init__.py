"""Architecture configs (a copy of ``repro.configs`` for the ported archs)."""

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.registry import get_config, get_smoke

__all__ = ["ArchConfig", "get_config", "get_smoke"]
