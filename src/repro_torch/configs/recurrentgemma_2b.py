"""recurrentgemma-2b [arXiv:2402.19427; hf]: 26L d=2560 10H (kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention 1:2, window 2048.  long_500k runs
(constant-size recurrent state + ring-buffer local KV).
Copy of ``repro.configs.recurrentgemma_2b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="recurrentgemma-2b", family="hybrid", n_layers=26, d_model=2560,
    n_heads=10, n_kv_heads=1, d_ff=7680, vocab=256000, head_dim=256,
    window=2048, recurrent_pattern=2, tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="recurrentgemma-smoke", family="hybrid", n_layers=8, d_model=64,
    n_heads=2, n_kv_heads=1, d_ff=128, vocab=512, head_dim=32, window=32,
    recurrent_pattern=2, tie_embeddings=True, remat=False,
)
