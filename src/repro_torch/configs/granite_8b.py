"""granite-8b [arXiv:2405.04324; hf]: 36L d=4096 32H (kv=8) d_ff=14336
vocab=49152 — llama-arch, code.  Pure full attention -> long_500k skipped.
Copy of ``repro.configs.granite_8b``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-8b", family="dense", n_layers=36, d_model=4096, n_heads=32,
    n_kv_heads=8, d_ff=14336, vocab=49152, skip_shapes=("long_500k",),
)

SMOKE = ArchConfig(
    name="granite-8b-smoke", family="dense", n_layers=3, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=128, vocab=512, remat=False,
)
