"""llama-3.2-vision-11b [hf:meta-llama; unverified]: 40L d=4096 32H (kv=8)
d_ff=14336 vocab=128256 — gated cross-attn image layers every 5th layer;
vision encoder STUB (precomputed patch embeddings).  long_500k skipped.
Copy of ``repro.configs.llama_3_2_vision_11b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm", n_layers=40, d_model=4096,
    n_heads=32, n_kv_heads=8, d_ff=14336, vocab=128256, cross_attn_every=5,
    num_image_tokens=1600, skip_shapes=("long_500k",), rope_theta=500_000.0,
)

SMOKE = ArchConfig(
    name="llama-vision-smoke", family="vlm", n_layers=4, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, cross_attn_every=2, num_image_tokens=16,
    remat=False,
)
