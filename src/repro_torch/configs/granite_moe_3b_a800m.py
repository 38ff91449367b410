"""granite-moe-3b-a800m [hf:ibm-granite; hf]: 32L d=1536 24H (kv=8)
per-expert d_ff=512 vocab=49155, MoE 40 experts top-8.  Full attention ->
long_500k skipped.
Copy of ``repro.configs.granite_moe_3b_a800m``."""
from repro_torch.configs.base import ArchConfig, MoESpec

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
    n_heads=24, n_kv_heads=8, d_ff=0, vocab=49155, head_dim=64,
    moe=MoESpec(num_experts=40, top_k=8, d_ff=512), skip_shapes=("long_500k",),
)

SMOKE = ArchConfig(
    name="granite-moe-smoke", family="moe", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, d_ff=0, vocab=512, moe=MoESpec(num_experts=8, top_k=4, d_ff=64),
    remat=False,
)
