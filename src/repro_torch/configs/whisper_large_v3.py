"""whisper-large-v3 [arXiv:2212.04356; unverified]: 32L enc + 32L dec,
d=1280 20H d_ff=5120 vocab=51866; conv frontend STUB (precomputed 1500-frame
embeddings).  long_500k skipped (full attention; 500k target tokens is
architecturally meaningless for Whisper).
Copy of ``repro.configs.whisper_large_v3``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec", n_layers=32, d_model=1280,
    n_heads=20, n_kv_heads=20, d_ff=5120, vocab=51866, encoder_len=1500,
    skip_shapes=("long_500k",),
)

SMOKE = ArchConfig(
    name="whisper-smoke", family="encdec", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=4, d_ff=128, vocab=512, encoder_len=24, remat=False,
)
