"""h2o-danube-1.8b [dense] — llama+mistral mix, sliding-window attention
[arXiv:2401.16818; hf]. SWA makes it long_500k-eligible."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000,
    swa_window=4096, rope_theta=10000.0,
)
