"""flux-mmdit (paper arch, FLUX.1-style): single-stream MMDiT simplification,
38 blocks d=3072 24H d_ff=12288; 512 text + 4096 vision tokens (the paper's
FLUX.1 4.5K-token setting).  Copy of ``repro.configs.flux_mmdit``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="flux-mmdit", family="dit", n_layers=38, d_model=3072, n_heads=24,
    n_kv_heads=24, d_ff=12288, vocab=0, head_dim=128, n_text_tokens=512,
    patch_dim=64, skip_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ArchConfig(
    name="flux-smoke", family="dit", n_layers=3, d_model=64, n_heads=2,
    n_kv_heads=2, d_ff=128, vocab=0, head_dim=32, n_text_tokens=32,
    patch_dim=16, remat=False,
)
