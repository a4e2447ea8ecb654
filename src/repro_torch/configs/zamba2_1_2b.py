"""zamba2-1.2b [hybrid] — Mamba2 backbone + SHARED attention block applied
every `attn_every` layers (weights reused — the paper-series parameter
sharing) [arXiv:2411.15242; hf]. ssm_state=64."""
from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000,
    attn_every=6,
    ssm=SSMCfg(d_state=64, d_conv=4, expand=2, version=2,
               n_heads=64, head_dim=64, chunk=64),
)
