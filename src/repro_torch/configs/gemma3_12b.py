"""gemma3-12b [hf:google/gemma-3-12b-pt; unverified]: 48L d=3840 16H (kv=8)
d_ff=15360 vocab=262144 — 5:1 local:global, 128k.
Copy of ``repro.configs.gemma3_12b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-12b", family="dense", n_layers=48, d_model=3840, n_heads=16,
    n_kv_heads=8, d_ff=15360, vocab=262144, head_dim=256, window=1024,
    global_every=6, tie_embeddings=True, rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="gemma3-12b-smoke", family="dense", n_layers=7, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, head_dim=16, window=32, global_every=3,
    tie_embeddings=True, remat=False,
)
