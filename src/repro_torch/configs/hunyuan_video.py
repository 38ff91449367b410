"""hunyuan-video-dit (paper arch, HunyuanVideo-style): 48 blocks d=3072 24H
d_ff=12288; 256 text + 32768 vision tokens (the paper's 33K setting, the
1.5x end-to-end target).  Copy of ``repro.configs.hunyuan_video``."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hunyuan-video-dit", family="dit", n_layers=48, d_model=3072,
    n_heads=24, n_kv_heads=24, d_ff=12288, vocab=0, head_dim=128,
    n_text_tokens=256, patch_dim=64,
    skip_shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
)

SMOKE = ArchConfig(
    name="hunyuan-smoke", family="dit", n_layers=3, d_model=64, n_heads=2,
    n_kv_heads=2, d_ff=128, vocab=0, head_dim=32, n_text_tokens=32,
    patch_dim=16, remat=False,
)
