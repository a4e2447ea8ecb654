"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6 fine-grained experts
[arXiv:2401.06066; hf]."""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    moe=MoECfg(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
)
