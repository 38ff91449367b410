"""mamba2-370m [arXiv:2405.21060; unverified]: 48L d=1024 attn-free,
vocab=50280, ssm_state=128 (SSD).  FlashOmni inapplicable (no attention,
DESIGN §Arch-applicability); long_500k runs (linear-time SSD).
Copy of ``repro.configs.mamba2_370m``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm", n_layers=48, d_model=1024, n_heads=32,
    n_kv_heads=32, d_ff=0, vocab=50280, ssm_state=128,
)

SMOKE = ArchConfig(
    name="mamba2-370m-smoke", family="ssm", n_layers=2, d_model=64, n_heads=2,
    n_kv_heads=2, d_ff=0, vocab=512, ssm_state=16, remat=False,
)
