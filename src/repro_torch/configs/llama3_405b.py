"""llama3-405b [arXiv:2407.21783; unverified]: 126L d=16384 128H (kv=8)
d_ff=53248 vocab=128256.  Pure full attention -> long_500k skipped.
ZeRO over the pod axis too (params+opt > single-pod HBM).
Copy of ``repro.configs.llama3_405b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama3-405b", family="dense", n_layers=126, d_model=16384,
    n_heads=128, n_kv_heads=8, d_ff=53248, vocab=128256,
    skip_shapes=("long_500k",), zero_over_pod=True, rope_theta=500_000.0,
)

SMOKE = ArchConfig(
    name="llama3-405b-smoke", family="dense", n_layers=3, d_model=64,
    n_heads=8, n_kv_heads=2, d_ff=192, vocab=512, remat=False,
)
