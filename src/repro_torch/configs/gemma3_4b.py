"""gemma3-4b [dense] — 5:1 local:global attention, 128k context
[hf:google/gemma-3-1b-pt; unverified]. Sliding window => long_500k runs."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, d_head=256,
    d_ff=10240, vocab=262144,
    swa_window=1024, swa_pattern=(5, 1),   # 5 local : 1 global
    rope_theta=1_000_000.0, tie_embeddings=True, act="gelu",
    qk_norm=True,
    attn_batch_fold=True,   # h=8 < TP=16: fold attention over all axes (§Perf W2)
)
