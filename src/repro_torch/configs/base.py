"""Architecture configuration schema and shape grid (copy of
``repro.configs.base``).

The port keeps its own copy so that it imports nothing of the JAX package.
The shape grid (``SHAPES``) is the task's:

  train_4k    : seq 4096,   global batch 256  -> train_step
  prefill_32k : seq 32768,  global batch 32   -> serve prefill
  decode_32k  : seq 32768,  global batch 128  -> serve decode (1 new token)
  long_500k   : seq 524288, global batch 1    -> long-context decode

:func:`repro_torch.launch.mesh.rules_for` reads it, and
:func:`repro_torch.configs.registry.arch_shapes` picks an arch's cells from it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["MoESpec", "ArchConfig", "SHAPES", "ShapeSpec"]


@dataclasses.dataclass(frozen=True)
class MoESpec:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden size


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


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

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 256 (the reference pads so the
        embedding shards evenly); logits are sliced back to ``vocab``."""
        return -(-self.vocab // 256) * 256 if self.vocab else 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks), the reference's
        formula: for a DiT it counts the attention and a 3-matrix MLP per
        block and nothing outside the blocks."""
        d, hd = self.d_model, self.hd
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.moe:
            mlp = self.moe.num_experts * 3 * d * self.moe.d_ff + d * self.moe.num_experts
        else:
            mlp = 3 * d * self.d_ff
        if self.family == "ssm":
            # Mamba2: in_proj (d -> 2*d_inner + 2*groups*state + heads), out_proj
            d_in = 2 * d
            attn, mlp = 0, d * (2 * d_in + 2 * self.ssm_state) + d_in * d
        return emb + self.n_layers * (attn + mlp)

    def n_active_params(self) -> int:
        """Parameters a token reaches, the reference's formula: a MoE
        counts ``top_k`` of its experts a layer; any other family, all."""
        if not self.moe:
            return self.n_params()
        d = self.d_model
        dense_part = self.n_params() - self.n_layers * self.moe.num_experts * 3 * d * self.moe.d_ff
        return dense_part + self.n_layers * self.moe.top_k * 3 * d * self.moe.d_ff
