"""qwen2-vl-2b [vlm] — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

Transformer BACKBONE only: the vision frontend is a stub — input_specs()
supplies precomputed patch embeddings + (3, B, S) M-RoPE position ids.
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
    d_ff=8960, vocab=151936,
    qkv_bias=True, rope_theta=1_000_000.0, mrope=True,
    tie_embeddings=True, embed_inputs=True,
)
