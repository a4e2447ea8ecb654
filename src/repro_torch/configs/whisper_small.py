"""whisper-small [audio] — enc-dec, conv frontend STUB [arXiv:2212.04356;
unverified]. input_specs() supplies precomputed frame embeddings (B, 1500, d);
12 encoder + 12 decoder layers, MHA, learned positions, GELU MLP.
Encoder-decoder: decode cells use the decoder with precomputed cross-KV;
long_500k skipped (full-attention decoder)."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865,
    n_enc_layers=12, enc_seq=1500,
    qkv_bias=True, act="gelu", embed_inputs=False,
)
