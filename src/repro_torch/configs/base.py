"""Architecture configuration schema (copy of ``repro.configs.base``).

The port keeps its own copy so that it imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoESpec", "ArchConfig"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm | dit
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None         # default d_model // n_heads
    moe: Optional[MoESpec] = None
    window: Optional[int] = None
    global_every: int = 1
    ssm_state: int = 0
    recurrent_pattern: int = 0
    encoder_len: int = 0
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    # DiT (the paper's own family)
    n_text_tokens: int = 0
    patch_dim: int = 0
    zero_over_pod: bool = False
    remat: bool = True
    scan_layers: bool = True
    skip_shapes: tuple[str, ...] = ()
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)
