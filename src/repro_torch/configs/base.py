"""Architecture config schema + shape suite for the assigned pool.

A copy of the JAX package's ``configs/base.py`` with the same fields and
arithmetic (it imports nothing of JAX). Every architecture in
``repro_torch/configs/<id>.py`` instantiates ``ArchConfig``.
``reduced()`` returns the CPU-smoke-test variant (same family/topology, tiny
dims). Shape applicability (which of the four shape cells run) is derived
from the family per DESIGN.md §Arch-applicability.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple



@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.001


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int
    d_conv: int = 4
    expand: int = 2
    version: int = 1            # 1 = Mamba1 (S6), 2 = Mamba2 (SSD)
    n_heads: int = 0            # Mamba2: #heads (d_inner = n_heads * head_dim)
    head_dim: int = 64
    chunk: int = 64             # scan chunk (activation-memory knob)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None           # default d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    mrope: bool = False                    # qwen2-vl M-RoPE (3-section rotary)
    swa_window: Optional[int] = None       # sliding-window size
    swa_pattern: Optional[Tuple[int, int]] = None  # (local, global) per cycle, e.g. (5,1)
    tie_embeddings: bool = False
    qk_norm: bool = False                  # gemma3 / qwen3 RMS-norm on q,k
    # batch-fold attention over (pod,data,model) when n_heads < TP (§Perf W2).
    # Big roofline win where replicated attention dominates (gemma3); off by
    # default because the fold boundary costs f32 cotangent copies (whisper
    # regressed on memory capacity).
    attn_batch_fold: bool = False
    norm_eps: float = 1e-6
    act: str = "silu"                      # mlp nonlinearity (swiglu gate)
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    # hybrid (zamba2): shared attention block applied every `attn_every` ssm layers
    attn_every: Optional[int] = None
    # encoder-decoder (whisper): n_layers = decoder layers; encoder below
    n_enc_layers: int = 0
    enc_seq: int = 1500                    # whisper frame count (stub frontend)
    # training
    dtype: str = "bfloat16"                # compute/param dtype (fp32 master in opt)
    remat: bool = True
    # modality stub: inputs are precomputed embeddings, not token ids
    embed_inputs: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (DESIGN.md §Arch-applicability)."""
        return self.family in ("ssm", "hybrid") or self.swa_window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all pool members autoregress (whisper via its decoder)

    def shapes(self) -> dict:
        """The four assigned input-shape cells; value None = skipped cell."""
        cells = {
            "train_4k": dict(kind="train", seq=4096, batch=256),
            "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
            "decode_32k": dict(kind="decode", seq=32768, batch=128),
            "long_500k": dict(kind="decode", seq=524288, batch=1),
        }
        if not self.sub_quadratic:
            cells["long_500k"] = None
        return cells

    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS = 6·N·D)."""
        d, L = self.d_model, self.n_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "vlm", "encdec"):
            h, kv, dh = self.n_heads, self.n_kv_heads, self.head_dim
            attn = d * h * dh + 2 * d * kv * dh + h * dh * d
            if self.qkv_bias:
                attn += (h + 2 * kv) * dh
            per_layer += attn + 2 * d  # norms
            if self.moe is not None:
                e = self.moe
                per_layer += (e.n_experts + e.n_shared) * 3 * d * e.d_expert
                per_layer += d * e.n_experts  # router
            else:
                per_layer += 3 * d * self.d_ff
        if self.family == "ssm":
            s = self.ssm
            di = s.expand * d
            per_layer += d * 2 * di + di * s.d_conv + di * (2 * s.d_state + 1) \
                + di * s.d_state + di + di * d + 2 * d
        if self.family == "hybrid":
            s = self.ssm
            di = s.expand * d
            per_layer += d * 2 * di + di * s.d_conv + s.n_heads * (2 * s.d_state) \
                + di + di * d + 2 * d
        n = emb + L * per_layer
        if self.family == "encdec":
            h, kv, dh = self.n_heads, self.n_kv_heads, self.head_dim
            enc_layer = d * h * dh * 2 + 2 * d * kv * dh + h * dh * d + 3 * d * self.d_ff + 3 * d
            n += self.n_enc_layers * enc_layer
        if self.family == "moe":
            pass
        return int(n)

    def active_param_count(self) -> int:
        """MoE: params touched per token (for 6·N_active·D)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        d, L = self.d_model, self.n_layers
        full_ffn = (e.n_experts + e.n_shared) * 3 * d * e.d_expert
        act_ffn = (e.top_k + e.n_shared) * 3 * d * e.d_expert
        return self.param_count() - L * (full_ffn - act_ffn)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=min(self.n_layers, 2 if self.attn_every is None else (self.attn_every + 1)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=16,
            dtype="float32",
            swa_window=8 if self.swa_window else None,
        )
        if self.moe is not None:
            kw["moe"] = MoECfg(n_experts=4, top_k=2, d_expert=32,
                               n_shared=self.moe.n_shared and 1)
        if self.ssm is not None:
            kw["ssm"] = SSMCfg(d_state=8, d_conv=4, expand=2,
                               version=self.ssm.version,
                               n_heads=2, head_dim=16, chunk=8)
        if self.attn_every is not None:
            kw["attn_every"] = 2
        # dataclasses.asdict turned nested configs into dicts for moe/ssm when unchanged
        if isinstance(kw.get("moe"), dict):
            kw["moe"] = MoECfg(**kw["moe"])
        if isinstance(kw.get("ssm"), dict):
            kw["ssm"] = SSMCfg(**kw["ssm"])
        return ArchConfig(**kw)
