"""mixtral-8x22b [arXiv:2401.04088; hf]: 56L d=6144 48H (kv=8) per-expert
d_ff=16384 vocab=32768, MoE 8 experts top-2, SWA -> all-local window 4096
(long_500k runs: sliding window is sub-quadratic).
Copy of ``repro.configs.mixtral_8x22b``."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="mixtral-8x22b", family="moe", n_layers=56, d_model=6144, n_heads=48,
    n_kv_heads=8, d_ff=0, vocab=32768, moe=MoESpec(num_experts=8, top_k=2, d_ff=16384),
    window=4096, global_every=0,
)

SMOKE = ArchConfig(
    name="mixtral-8x22b-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=0, vocab=512, moe=MoESpec(num_experts=4, top_k=2, d_ff=96),
    window=32, global_every=0, remat=False,
)
