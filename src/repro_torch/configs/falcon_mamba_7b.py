"""falcon-mamba-7b [ssm] — pure Mamba1 (S6 selective scan), attention-free
[arXiv:2410.05355; unverified]. ssm_state=16, d_inner = 2*d_model."""
from repro_torch.configs.base import ArchConfig, SSMCfg

CONFIG = ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024,
    ssm=SSMCfg(d_state=16, d_conv=4, expand=2, version=1, chunk=64),
)
