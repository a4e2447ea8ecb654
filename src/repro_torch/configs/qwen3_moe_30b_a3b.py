"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.configs.base import ArchConfig, MoECfg

CONFIG = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_head=128,
    d_ff=768, vocab=151936,
    rope_theta=1_000_000.0,
    qk_norm=True,
    moe=MoECfg(n_experts=128, top_k=8, d_expert=768, n_shared=0),
)
