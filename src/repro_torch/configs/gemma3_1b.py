"""gemma3-1b [hf:google/gemma-3-1b-pt; unverified]: 26L d=1152 4H (GQA kv=1)
d_ff=6912 vocab=262144 — 5:1 local:global sliding window, 128k context.
Copy of ``repro.configs.gemma3_1b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-1b", family="dense", n_layers=26, d_model=1152, n_heads=4,
    n_kv_heads=1, d_ff=6912, vocab=262144, head_dim=256, window=512,
    global_every=6, tie_embeddings=True, rope_theta=1_000_000.0,
)

SMOKE = ArchConfig(
    name="gemma3-1b-smoke", family="dense", n_layers=7, d_model=64, n_heads=4,
    n_kv_heads=1, d_ff=128, vocab=512, head_dim=16, window=32, global_every=3,
    tie_embeddings=True, remat=False,
)
